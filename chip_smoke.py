#!/usr/bin/env python3
"""Drive the PyTorch port's PatchMatch densify (serial and sharded), mesh
refinement (its iterations as CUDA graphs), mesh texturing and SGM densify
paths, the whole chain densify
-> mesh -> clean -> refine -> texture -> save, the same chain from files
through the port's CLI, a distorted SfM model imported, undistorted, densified,
evaluated, transformed and split, the reference's project archives, and
densify's remaining modes and switches with the dumps and viewers, on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device     - fails without CUDA; prints the card's name and power
                  limit, then whether PIL, torchvision and
                  torchvision.io.decode_jpeg import on this host, with their
                  versions (the evidence for choosing the port's image
                  decoder; printed only)
  2. build      - builds the CUDA kernels from csrc/ (one nvcc per source,
                  all started together; sm_90a)
  3. kernels    - the multi-view scorer K1-mv (exact, nn), K2-mv (exact) and
                  its precomputed-term mode (exact), the multi-view
                  geometric kernel K3-mv, and the per-view K1 (exact, nn),
                  K2, K3 and K1-v2 (exact, nn), at the main path's shapes
                  (C=11 and C=1) against their plain PyTorch versions on the
                  card, with timings; the multi-view rows bit for bit (NaN
                  included), and against the per-view route they replace (V
                  launches of K1, K2 or K3 plus the PyTorch epilogue or
                  stack), timed in the same call; K1-v2 against K1; the
                  cross-view filter's splat and decide kernels at 800x600
                  with 8 neighbours against their plain twin (bit for bit)
                  and the host NumPy filter (share of equal pixels); fusion's
                  kernels on the same 9 views with normals and colours
                  against their twin on the CPU and the host NumPy fusion
                  (bit for bit), one row for the whole job
  4. variants   - K1 against K1-v2 on the dev script's inputs (C=11,
                  480x640, T=25): times, and the share of (candidate, pixel)s
                  whose texels all came from K1-v2's staged window; then
                  the same with candidate depths spread wide enough that
                  in-bounds footprints leave the window (K1-v2's re-read
                  from the image), held to K1 bit for bit
  5. densify    - the synthetic 5-view 480x640 scene through
                  densify.dense_reconstruction(scene, DenseOptions()) on the
                  card, its sweeps replayed as CUDA graphs (ops/graphs.py):
                  throughput, point count, kernel launches (one multi-view
                  launch per score_hypotheses call, counted per replay, no
                  per-view K1/K2), captures, their seconds, replays and the
                  graph pool's bytes, and depth accuracy/completeness per
                  view against ground truth, held to 95% of what the JAX
                  package reaches on the same scene; then the same call with
                  the sweeps launched one by one (_eager): its photometric,
                  geometric and whole-call seconds beside the graphed ones,
                  and maps (depth, normal, confidence), cloud and launches
                  equal to the graphed run's to the bit; the graphed cloud
                  goes on to phase pipeline
  5b. multidevice - right after densify, on make_mesh(4) = (2, 2) shards of
                  the one card: estimate_views_sharded (photometric and 2
                  geometric passes) against the serial port run with
                  OMVS_EARLY_EXIT=0, pass by pass (share of equal pixels per
                  view, at least 0.999; seconds of each; K1-mv exact/nn and
                  K2-mv launches, K2-mv 3 per tile block, view and pass);
                  dense_reconstruction(mesh=...) (points within 1% of phase
                  densify's, quality within its bounds); filter_views_sharded
                  against the host filter (masks, and depths within 1e-3,
                  above 0.99) and against itself on the CPU (equal);
                  _run_views_parallel with two workers on the card against
                  one (bit for bit, seconds); label_faces_lbp_sharded over
                  4 shards on phase texture's qualities (labels equal on
                  0.999, ms); refine's pair axis over 2 shards (one
                  _energy_grad within rel 1e-5 / rtol 1e-4, the whole
                  refine_mesh within 1.05x the one-shard height error);
                  sgm_pairs_sharded and fusion_reduce_sharded against their
                  serial counterparts (0.999)
  6. profile    - torch.profiler over one view's photometric
                  estimate_depth_map at 480x640, eager and with graphs
                  captured by an earlier call (timed): seconds, device-busy
                  share, kernels run on the device, the host's kernel
                  launches and graph replays, the top 10 device kernels by
                  time, host time per sweep; the graphed map equal to the
                  eager one
  7. geom_split - the same under OMVS_GEOM_SPLIT=1 (geometric sweeps split
                  into candidates, K3-mv, then the scorer with the terms
                  precomputed, and selection): launches, quality, and
                  agreement with phase densify's maps
  8. parity     - the same scene at 120x160 (3 views) on the card against
                  the port's plain versions on the CPU
  9. geom_unfused - the 120x160 scene on the card under OMVS_GEOM_FUSED=0
                  (K3-mv, then the precomputed mode, in place of K2-mv)
                  against phase parity's card maps
 10. refine     - refine.refine_mesh(scene, mesh, RefineOptions()) on the
                  card for the 5-view 640x480 scene and the height field's
                  150-grid (44,402 faces) with z-noise N(0, 0.05), its
                  iterations replayed from CUDA graphs (refine.IterProgram):
                  seconds per call and scale, pairs, refreshes, host
                  seconds, peak memory, captures, their seconds, replays and
                  pool bytes, segment_sum launches, mean height error before
                  and after (held to 0.85x its start and 1.05x the JAX
                  package's); the same call with _eager=True (seconds;
                  vertices equal to the bit); CUDA-event ms of one
                  full-scale iteration eager and replayed; torch.profiler
                  over one full-scale refresh block eager and graphed
                  (launches and replays per iteration, busy share); the
                  segment sums of one full-scale iteration through the
                  segment_sum kernel against its plain version on the card
                  and _segment_sum's CPU form, bit for bit, with ms (graph
                  replay, eager, with the sort), plain ms,
                  torch.segment_reduce's ms and the bound; card against CPU
                  on the tests' small case and for one full-scale
                  _energy_grad
 11. texture    - texture.texture_mesh(scene, mesh, TextureOptions()) with
                  LBP labeling on the card, for the same scene (with its
                  colors, which only this phase reads) and the height
                  field's 320-grid (203,522 faces): seconds per stage
                  (qualities, outliers, adjacency, labeling, generate,
                  global and local leveling, sharpen) and per call, the
                  unseen share and whether the MRF was restricted, patches,
                  pages, atlas size, peak memory, the faces' size in pixels
                  per view; CUDA-event ms of label_faces_lbp and of its
                  message schedule alone, its launches and device-busy
                  share under torch.profiler; the same record for the
                  150-grid (44,402 faces of several pixels each). Holds:
                  the card's labels equal the CPU's for the same
                  qualities, and texture_mesh on the card equals it on the
                  CPU (labels and texcoords equal, texels within 1 and at
                  least 99.9% equal); the color fidelity (per face, the
                  mean |atlas - source| color at the centroid) has a median
                  at most 1.02x the JAX package's and a share of faces
                  within 5 at least 0.98x the JAX package's. Plain PyTorch:
                  no Pallas kernel here either
 12. sgm        - densify.dense_reconstruction(scene, DenseOptions(
                  estimator="sgm")) on the card for phase densify's scene
                  (5 views at 640x480, 8 directions, lc_blend, max_num_d
                  256): depth maps/s for the call and for estimation alone
                  (as bench.py's sgm_maps_per_s), seconds per pair and per
                  level with (h, w, num_d), points, peak memory, depth
                  accuracy/completeness per view held to 95% of the JAX
                  package's; fusion_mode=-1 writes one .dimap per pair and
                  -2 resumes to the same cloud (and, with the .dmap files
                  gone, re-projects the .dimap files without matching: their
                  1/4-pixel disparities give a smaller cloud, as in the JAX
                  package); each matching level runs as a CUDA graph of
                  its shape class (sgm.LevelProgram): the call's captures,
                  replays and pool bytes, and no capture in a pair whose
                  classes were captured before; sgm_scan and wzncc_volume
                  launches over the call; one full-width pair's
                  disparities and costs graphed (first run, capture,
                  replay) equal to eager ones, which equal the CPU's;
                  torch.profiler over that pair eager and graphed: host
                  kernel launches, graph replays, captures, kernels run
                  and the device-busy share, launches per eager
                  aggregate8; sgm_scan against _scan_passes_plain on the
                  card, bit for bit with signed zeros, for the horizontal,
                  vertical and diagonal batches of that pair's finest
                  aggregate8 and for aggregate's two, with ms (graph
                  replay and eager), plain ms and the bound, and at D 257,
                  384 and 512 (the carry read back from the output);
                  wzncc_volume against its plain version bit for bit at
                  the level shapes (2, 240, 320) with D 32 and 64 and (2,
                  480, 640) with D 64 and 128, with ms, plain ms and the
                  bound; match_pair_tsgm(max_num_d=512) on a 120x160 pair
                  with a widened range, card equal to CPU; rectify_warp
                  (each pair of the call rectified on the card, one launch a
                  pair) against the host warp bit for bit on view 0's pair
                  and at the benchmark's 800x600: the kernel's ms from the
                  profiler, the card step (upload, launch, download) and
                  rectify_pair's against the host warp's, and the bound
 13. pipeline   - phase densify's cloud through the rest of the chain:
                  reconstruct.reconstruct_mesh(scene, MeshOptions()) on the
                  host (points before and after dedup, tets, raw faces,
                  seconds of dedup, Delaunay, ray walk with the cut and
                  extraction; run twice, whether the faces are equal),
                  mesh_ops.clean_mesh(decimate=0.5) (faces, seconds),
                  refine.refine_mesh(RefineOptions(scales=2, iters=16)) on
                  the card (seconds, peak memory), texture.texture_mesh(
                  TextureOptions()) on the card for the scene with its
                  colors (seconds per stage, unseen share, pages), then the
                  dense cloud, the clean and refined meshes (PLY) and the
                  textured mesh (OBJ, MTL, PNG pages) saved and read back
                  with the port's loaders (equal; file sizes). Holds, from
                  the JAX package's figures for the same chain: raw and
                  clean faces within 5%; the clean mesh's mean height error
                  at most 1.05x and its share within HEIGHT_TOL at least
                  0.98x, over the vertices in the height field's domain;
                  refinement does not raise the height error; color
                  fidelity as phase texture holds it. Meshing, cleaning and
                  the codecs are host code (no Pallas kernel in the JAX
                  package): no kernel is added
 14. files      - the port run from files as a user runs it: the colored
                  scene at 1280x960 written as 5 JPEGs (quality 95, PIL;
                  their sha256 printed) and scene.mvs, then densify through
                  openmvs_tpu_torch.__main__.main(["densify", "scene.mvs"])
                  (images decoded and brought to 640x480; launches as phase
                  densify's, tower and ROI outcomes, peak memory), and
                  mesh --decimate 0.5, refine --scales 2 --iters 16 and
                  texture as `python -m openmvs_tpu_torch` commands on the
                  full images (seconds per command and stage, peak memory);
                  the loading layer timed (decode, area resize, to_gray,
                  .mvs read and write). Holds, from the JAX package's CLI
                  on the same files (tests/_torch_cli_quality.py): points
                  and faces within 5%, the cloud's and the meshes' height
                  error at most 1.05x and shares at least 0.98x,
                  refinement not raising the error, color fidelity as
                  phase texture holds it (_file_color_fidelity: the labels
                  do not survive the files); scene_dense.mvs read back
                  equals the cloud densify held
 15. imports    - real SfM input from files: the colored scene seen
                  through a distorted OPENCV camera (synthetic.DISTORTION)
                  and written as an ETH3D scene (5 JPEGs of 1280x960 at
                  quality 95, a COLMAP text calibration in
                  dslr_calibration_jpg/, scan_clean/scan.ply;
                  synthetic.write_eth3d_files), then import-colmap as a
                  command (the images undistorted by the port's numpy
                  rebuild of cv2.undistort; their sha256 printed),
                  densify through __main__.main (launches as phase
                  files'), eval --dataset eth3d --run --device cuda, and
                  on the host eval --est of the dense cloud, transform
                  --matrix then --align-file back, --max-resolution 640,
                  --compute-volume of the height field's mesh, and densify
                  --split-max-points 100000; as a control the same files
                  imported as PINHOLE with the coefficients dropped and
                  densified. Seconds of each step, peak memory, and the
                  control's height error beside the undistorted one and
                  phase files'. Holds, from the JAX package on the same
                  files (tests/_torch_import_quality.py): distorted and
                  undistorted JPEG bytes equal, points within 5%, the
                  cloud's height error at most 1.05x and its share within
                  HEIGHT_TOL at least 0.98x, F-scores of both evals within
                  0.01, the align round trip within 1e-6, rescaled JPEG
                  bytes equal, the volume within 1e-6 relative, chunk
                  counts and views equal with points within 5% (the
                  clouds differ by argmin flips), and the undistorted
                  cloud nearer the truth than the control's
 16. project    - the reference's boost "MVS project" archives on phase
                  files' folder: scene.mvs with the mesh of its mesh command
                  saved by Scene.save_project as TEXT, BINARY, BINARY_ZIP and
                  BINARY_ZSTD (zstd left out, and said so, where the host's
                  libzstd does not load; phase device prints whether it
                  does) and read back equal to the .mvs load (seconds, file
                  bytes); the C++ emitter's golden archive read and written
                  back byte for byte; densify through __main__.main on the
                  zstd project on the card (launches as phase files'),
                  points within 1% of phase files'
 17. switches   - densify's remaining modes and switches: the flagged
                  multi-view scorer (band skipping: K1-mv exact and nn,
                  K2-mv) against score_views_plain with the same flags bit
                  for bit, with half of the bands off and all on (equal to
                  the unflagged kernel), CUDA-graph ms of each; with all
                  bands off and NaN images and weights, the sentinel; a full
                  densify under OMVS_ACTIVE=5e-3 with OMVS_EARLY_EXIT=0 beside
                  the same run without OMVS_ACTIVE (seconds, share of band
                  half-sweeps skipped, launches, points, quality held as
                  phase densify's); three exact photometric and geometric
                  sweeps with skipping through patchmatch.sweep (the flagged
                  exact and K2-mv launches); at 120x160 the card against the
                  CPU for two warp sweeps and one view under OMVS_ALL_EXACT
                  and OMVS_EARLY_EXIT=0, held to phase parity's agreement;
                  OMVS_PROFILE_DIR writing a trace; dump -o of a .dmap of
                  phase project; render_mesh and export_html of phase
                  pipeline's textured mesh
Each of phases 4, 5, 5b, 7, 9, 10, 12, 14, 15, 16 and 17 sets the launch
counts to 0 just before the path it drives and reads them just after (10
the segment_sum count, 12 the sgm_scan and wzncc_volume counts beside the
PatchMatch ones). Then the {"kernels": [...]} line
and, last, {"ok": true, "device": ...}. Any failure raises and exits
non-zero. Imports nothing of JAX.
"""

import contextlib
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Per-view (accuracy, completeness) of the JAX package on the same scene,
# 480x640, 5 views, DenseOptions(), CPU, measured with
#   JAX_PLATFORMS=cpu python tests/_torch_jax_quality.py --height 480 --width 640
# (288468 points, 668 s on 4 CPU cores)
JAX_ACCURACY = [0.9904370367939697, 0.9914687213715482, 0.9839826680865127,
                0.9906634129450852, 0.9894338372725767]
JAX_COMPLETENESS = [0.963409963432761, 0.9450504042475226, 0.9660440752877728,
                    0.9466281181192615, 0.9618086060578184]

# Mean |z - height(x, y)| over the vertices that the JAX package's
# refine_mesh reaches on phase refine's workload (5 views at 640x480, the
# 150-grid with z-noise N(0, 0.05) from default_rng(11), RefineOptions()),
# CPU, measured with
#   JAX_PLATFORMS=cpu python tests/_torch_refine_quality.py --height 480 --width 640
# (0.039844 before refinement; 53.7 s on the CPU)
JAX_REFINE_HEIGHT_ERROR = 0.010049285568380237

# Median over the labelled faces of the mean |atlas color - source color| at
# the face's centroid in its labelled view (_color_fidelity) that the JAX
# package's texture_mesh reaches on phase texture's workload (5 views at
# 640x480 with colors, the 320-grid of 203,522 faces, TextureOptions()),
# CPU, measured with
#   JAX_PLATFORMS=cpu python tests/_torch_texture_quality.py --height 480 --width 640
# (14.9% of faces unseen, one 4096x2048 page; 9.44 s on the CPU), and the
# share of the labelled faces whose mean difference is at most
# FIDELITY_BOUND, from the same run
JAX_TEXTURE_FIDELITY = 1.6666666666666667
FIDELITY_BOUND = 5
JAX_TEXTURE_WITHIN = 0.9692992586091415

# the share of a mesh's vertices within HEIGHT_TOL of the height field
# (_mesh_height_quality)
HEIGHT_TOL = 0.01

# The JAX package's figures for phase pipeline's chain on the same scene
# (5 views at 640x480): dense_reconstruction(DenseOptions()) (288,468
# points), reconstruct_mesh(MeshOptions()), clean_mesh(decimate=0.5),
# refine_mesh(RefineOptions(scales=2, iters=16)), texture_mesh(
# TextureOptions()) on the scene with its colors; raw and clean faces,
# _mesh_height_quality of the clean and the refined mesh, _color_fidelity
# of the textured mesh. CPU (8 cores), measured with
#   JAX_PLATFORMS=cpu python tests/_torch_mesh_quality.py --height 480 --width 640
# (541 s: densify 489.4, mesh 15.2, clean 2.6, refine 27.0, texture 7.3)
JAX_RAW_FACES = 191314
JAX_CLEAN_FACES = 95688
JAX_CLEAN_HEIGHT_ERROR = 0.006926291612376185
JAX_CLEAN_WITHIN = 0.7568072554741461
JAX_REFINED_HEIGHT_ERROR = 0.006546988798596461
JAX_REFINED_WITHIN = 0.7856228892664611
JAX_PIPELINE_FIDELITY = 1.6666666666666667
JAX_PIPELINE_WITHIN = 0.9787213881109309

# The JAX package's CLI figures for phase files: synthetic.write_scene_files
# (5 views of 1280x960, JPEG quality 95 through PIL 12.1.0, scene.mvs), then
# python -m openmvs_tpu densify scene.mvs; mesh scene_dense.mvs --decimate
# 0.5; refine ... --scales 2 --iters 16; texture ..., on the CPU (8 cores),
# measured with
#   JAX_PLATFORMS=cpu python tests/_torch_cli_quality.py
# (densify 574.1 s, mesh 67.7, refine 117.7, texture 23.0): the dense
# points, _mesh_height_quality of the points, of the clean and of the
# refined mesh, the raw faces (the meshing log's "surface:" line), the clean
# faces, and _file_color_fidelity of the textured mesh; and the sha256 of
# the JPEGs they came from
JAX_CLI_JPEG_SHA256 = {
    "view0000.jpg": "9de099d30b07695e202d4f871a4632a3b5f3631ff25836ede0c960b2020cfa3f",
    "view0001.jpg": "eb48a81bc858675669f3c77ef46b276444d40d3b9ee1839a0ac989d170add305",
    "view0002.jpg": "1b4c93437ab69e22596db72330c0ebbfcc69db08cebee6b306b9d2e4675e5eaa",
    "view0003.jpg": "dacdd55af21adfafb81a8935ce60d114ccafa889b71f2583676769227ec0c7ff",
    "view0004.jpg": "b31c3e6c6a726f452675c995e3f5efa76bfe47acc6bcdf13a6423f432799eb97",
}
JAX_CLI = {"points": 288104, "cloud_height_error": 0.008126990339840809,
           "cloud_within": 0.6841376498868381, "raw_faces": 351427,
           "clean_faces": 175736, "clean_height_error": 0.00848924974199139,
           "clean_within": 0.6660122811422832,
           "refined_height_error": 0.008393922736098272,
           "refined_within": 0.6703529174735005, "color_fidelity": 1.0,
           "faces_within": 0.9934165962234999}

# The JAX package's figures for phase imports: synthetic.write_eth3d_files
# (the colored scene through an OPENCV camera with synthetic.DISTORTION, 5
# JPEGs of 1280x960 at quality 95, the COLMAP text calibration and
# scan_clean/scan.ply), then python -m openmvs_tpu import-colmap (cv2
# undistorts), densify scene.mvs, eval --dataset eth3d --run, and
# _host_steps (eval --est, transform, --split-max-points), on the CPU (8
# cores), measured with
#   JAX_PLATFORMS=cpu python tests/_torch_import_quality.py
# (densify 475.6 s, eval --run 459.8 s): the sha256 of the distorted and
# the undistorted JPEGs, the dense points, _mesh_height_quality of the
# cloud, the F-scores of both evals, the align round trip's error, the
# sha256 of the rescaled images, the leveled volume and the chunks
JAX_IMPORTS = {
    "jpeg_sha256": {
        "view0000.jpg": "ca40b28feed1eefa0d9a6d53aee1ef79c09c8805c17c83a9cb43b4d90ac7796a",
        "view0001.jpg": "05efbc7abaaf7aa6cfeea4f7e57e13d7a4f0f90a6cf7acf8991558d04befae6d",
        "view0002.jpg": "195413b936af8b066960e48974c5f4d5180e1ef8e5a4ab36019abf3f43ab1bc3",
        "view0003.jpg": "5239babf6af4e45b3a3c6811694c06c7cb6272bcba874af6a69c643a47c1dbf4",
        "view0004.jpg": "19dc44aec33138dbf67918c43164660610e7f303190f1705a379f601fc221173"
    },
    "undistorted_sha256": {
        "view0000.jpg": "aad4a3942c3bba97c7c5dfe53b79ee42db2900caad78fcf14cd639a888088d5c",
        "view0001.jpg": "a1000a7f9b7e16efa1171abc6ed74aaed012579b884b7dd11180550eb976caee",
        "view0002.jpg": "e0f3af51f77ff69517dc00ce9ad72bcacfd46a8262bd2764ef3b391de37a9543",
        "view0003.jpg": "3a4a58feffa60cfebea32b5727f85c57d9f71c86e59cb21816acd9b850fae762",
        "view0004.jpg": "aaefffd66fce5b2fc2bc8ce69c9ab85f7e65affeb1bce74dec59716d72c33ad9"
    },
    "points": 288490,
    "cloud_height_error": 0.008137063537242814,
    "cloud_within": 0.684735484868287,
    "run_fscores": {
        "1cm": 0.7072274889425041,
        "2cm": 0.9416503345978743,
        "5cm": 0.9756327639413935,
        "10cm": 0.9841405238004024
    },
    "est_fscores": {
        "1cm": 0.7072274889425041,
        "2cm": 0.9416503345978743,
        "5cm": 0.9756327639413935,
        "10cm": 0.9841405238004024
    },
    "align_matrix_error": 1.3322676295501878e-15,
    "scaled": {
        "view0000.jpg": "ea25e747f67cc6ff3d178e2d9661b2f89a44d1a937a3de9cd6e2dde003ec70e5",
        "view0001.jpg": "b18ec468088a94edfe2580901ed207f353a29acf2cbc65b00776b62a42ef4cf5",
        "view0002.jpg": "053bb17c4b68d27de75d1b70615e086efbbc984e15f555fe56db8e62a0fa4a46",
        "view0003.jpg": "a563c1919a4eca245466f3a4192c3b6865a25d80262b53e41b694cbbe0174b78",
        "view0004.jpg": "d2e56df171e8ff734a6fa03821dbeffd1e3ca339010b39b338d78b1161e651f6"
    },
    "volume": 0.0010366428905346226,
    "chunks": [
        {
            "points": 80377,
            "views": 5
        },
        {
            "points": 80060,
            "views": 5
        },
        {
            "points": 79730,
            "views": 5
        },
        {
            "points": 80596,
            "views": 5
        }
    ]
}

# Per-view (accuracy, completeness) of the JAX package's SGM estimator on
# phase densify's scene (480x640, 5 views, DenseOptions(estimator="sgm")),
# CPU, measured with
#   JAX_PLATFORMS=cpu python tests/_torch_sgm_quality.py --height 480 --width 640
# (232,524 points, 276 s on the CPU)
JAX_SGM_ACCURACY = [0.9686011654148001, 0.9718663110707598, 0.9685157348825745,
                    0.9669701818181818, 0.9606766451155788]
JAX_SGM_COMPLETENESS = [0.672946626421426, 0.6835954250251437, 0.7375995443222334,
                        0.6711149799707735, 0.668567880223546]

# H100 SXM peaks (NVIDIA data sheet): fp32 and fp64 outside the tensor
# cores, HBM3
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
# wzncc_volume's operations per (pixel, disparity), counted from
# csrc/wzncc_volume.cu: 6 fp32 a texel (three products, three adds), 8 in
# the epilogue (s s, the division, the subtraction, the product with the
# rsqrt, 1 - min, the min, the product by 255, the rounding) and 4 fp64
# (the fused multiply-add's product and add, the division, the root)
WZNCC_FLOP_TEXEL = 6
WZNCC_FLOP_EPILOGUE = 8
WZNCC_FLOP64 = 4
# fp32 operations per (candidate, pixel), counted from csrc/pm_common.cuh
# with an fma as two: per texel (warp, bounds, sample, accumulate), per
# pixel (setup, ZNCC epilogue), and the geometric term of K2 and K3
FLOP_TEXEL = {"exact": 50, "nn": 37}
FLOP_PIXEL = 44
FLOP_GEOM = 83
# of FLOP_TEXEL, the view-independent part of the texel warp (n . goff and
# the scale), which the multi-view scorer computes once for all views
FLOP_SHARED = 7
# per view and (c, p), finish_view and the best-two fold
FLOP_FINISH = 10
# (launch-counter name, sampling mode, kind): K1, K2 and K1-v2 in the modes
# the kernel sources instantiate, and K3; K2 in "nn" mode is not on the
# main path (geometric passes score exact) and is checked here only
KERNELS = (("score_view_exact", "exact", "k1"),
           ("score_view_nn", "nn", "k1"),
           ("score_view_geom_exact", "exact", "k2"),
           ("score_view_geom_nn", "nn", "k2"),
           ("geom_term", "exact", "k3"),
           ("score_view_v2_exact", "exact", "v2"),
           ("score_view_v2_nn", "nn", "v2"))
# the multi-view scorer: (counter, sampling mode, geometric mode) on the
# main path (geometric passes score exact; the precomputed mode serves the
# split sweep and OMVS_GEOM_FUSED=0)
VIEW_KERNELS = (("score_views_exact", "exact", "none"),
                ("score_views_nn", "nn", "none"),
                ("score_views_geom_exact", "exact", "geom"),
                ("score_views_pre_exact", "exact", "pre"))
MAIN_PATH = ("score_views_exact", "score_views_nn", "score_views_geom_exact")
PER_VIEW = ("score_view_exact", "score_view_nn", "score_view_geom_exact",
            "score_view_geom_nn")
# the {"kernels": [...]} line: (counter, source, TPU kernel replaced, the
# phase whose run gives the launches; "switches" is phase switches' densify
# under OMVS_ACTIVE, "sweeps" its exact and geometric sweeps with skipping)
KERNEL_LINE = (
    ("score_views_exact", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:819", "densify"),
    ("score_views_nn", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:819", "densify"),
    ("score_views_geom_exact", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:979", "densify"),
    ("score_views_pre_exact", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:819", "geom_split"),
    ("score_view_exact", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:819", "densify"),
    ("score_view_nn", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:819", "densify"),
    ("score_view_geom_exact", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:979", "densify"),
    ("geom_term", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:691", "geom_split"),
    ("geom_terms", "pm_geom_views.cu", "openmvs_tpu/ops/pm_kernel.py:691", "geom_split"),
    ("score_view_v2_exact", "pm_score_v2.cu", "scripts/dev_kernel_variants.py:282", "variants"),
    ("score_view_v2_nn", "pm_score_v2.cu", "scripts/dev_kernel_variants.py:282", "variants"),
    ("score_views_act_nn", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:819", "switches"),
    ("score_views_act_exact", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:819",
     "switches_exact"),
    ("score_views_geom_act_exact", "pm_score_views.cu", "openmvs_tpu/ops/pm_kernel.py:979",
     "sweeps"),
    # the jitted programs' kernels: the SGM scans of aggregate8, the ordered
    # segment sums of refine's _device_iter, the masked WZNCC volume of
    # _wzncc_volume0 and mask_volume (rows of one aggregate8 call, of one
    # iteration and of one (2, 480, 640) level with D = 64, phases sgm and
    # refine)
    ("sgm_scan", "sgm_scan.cu", "openmvs_tpu/ops/sgm.py:519", "sgm"),
    ("wzncc_volume", "wzncc_volume.cu", "openmvs_tpu/ops/sgm.py:335", "sgm"),
    ("segment_sum", "segment_sum.cu", "openmvs_tpu/refine.py:531", "refine"),
    # SGM's rectification, where the JAX package calls cv2.warpPerspective
    # on the host (a row of one 800x600 pair, both images)
    ("rectify_warp", "rectify_warp.cu",
     "none: host cv2.warpPerspective, openmvs_tpu/ops/sgm.py:269-270", "sgm"),
    # the cross-view filter's kernels, where the JAX package has host NumPy
    # and no TPU kernel (rows of one 800x600 view with 8 neighbours)
    ("filter_splat", "filter_splat.cu",
     "none: host NumPy, openmvs_tpu/ops/filters.py project_depth_to_view", "densify"),
    ("filter_decide_adjust", "filter_splat.cu",
     "none: host NumPy, openmvs_tpu/ops/filters.py filter_depth_adjust", "densify"),
    # fusion's kernels, where the JAX package fuses on the host in NumPy
    # (one row for one 9-view 800x600 fusion, 8 neighbours a view: every
    # kernel's launches, the twin and the bound of the whole job)
    ("fuse_views", "fuse_views.cu",
     "none: host NumPy, openmvs_tpu/ops/fusion.py fuse_depth_maps", "densify"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, graph=False):
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, after one
    warm-up call. ``graph`` replays one call captured in a CUDA graph, so
    the time is the device's alone: a kernel of tens of microseconds
    otherwise waits on its wrapper's host work."""
    import torch

    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    emit({"phase": "device", "image_decoders": _image_decoders()})
    emit({"phase": "device", "libzstd": "loads" if _zstd_loads() else "absent"})
    return card


def _image_decoders():
    """Whether PIL, torchvision and torchvision.io.decode_jpeg import on this
    host, and their versions (ROADMAP Queue 1, item 4 chooses the port's
    image decoder from this). Prints only: no path uses them."""
    import importlib

    out = {}
    for name, attr in (("PIL", None), ("torchvision", None),
                       ("torchvision.io", "decode_jpeg")):
        try:
            mod = importlib.import_module(name)
            if attr is not None:
                getattr(mod, attr)
                name = f"{name}.{attr}"
            out[name] = {"imports": True, "version": getattr(mod, "__version__", None)}
        except Exception as e:  # noqa: BLE001 - the failure is the finding
            out[name if attr is None else f"{name}.{attr}"] = {
                "imports": False, "error": f"{type(e).__name__}: {e}"[:200]}
    return out


def phase_build():
    from openmvs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in _build.SIGNATURES:
        _build.library(name)
    sources = {}
    for name, info in _build.BUILD_INFO["sources"].items():
        # per entry function (kernel): registers and spill bytes; the spill
        # lines of called functions (the division slow paths) do not count
        kernels = re.findall(
            r"Function properties for (\w+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
            r"spill stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers",
            info["log"])
        sources[name] = {
            "nvcc_seconds": info["seconds"],
            "registers_per_thread": [int(r) for *_, r in kernels],
            "spill_bytes": [int(st) + int(ld) for _, _, st, ld, _ in kernels],
            "stack_bytes": [int(sf) for _, sf, *_ in kernels],
            "sass": _sass_loops(os.path.join(_build.BUILD_INFO["dir"],
                                             name.replace(".cu", ".so")))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "parallel_nvcc_seconds": _build.BUILD_INFO["seconds"],
          "sources": sources})


def _sass_loops(lib):
    """Per kernel of the library ``lib`` (by its name and template
    arguments, as mangled): the SASS instruction count and the lengths of
    its loops of 32 instructions or more (each backward branch's span, in
    instructions), from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    funcs, code = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : \S*?\d+(pm_[a-z0-9_]+(?:I[A-Za-z0-9]+?E)?)", line)
        if m:
            code = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and code is not None:
            code.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, code in funcs.items():
        loops = set()
        for addr, text in code:
            b = re.search(r"\bBRA(?:\.\S+)? (0x[0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                n = (addr - int(b.group(1), 16)) // 16 + 1
                if n >= 32:
                    loops.add(n)
        out[name] = {"instructions": len(code), "loops": sorted(loops)}
    return out


def _kernel_inputs(C, device, scene, gts):
    """Main-path operands: view 2 of the 480x640 synthetic scene against
    its four neighbours, C candidate planes around the true depth, and a
    low-res prior (the truth within 2%, 30% holes), as the photometric
    pyramid's finer levels have one."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions

    opts = DenseOptions()
    ref = 2
    nbrs = [0, 1, 3, 4]
    cam = scene.images[ref].working_camera()
    rp = np.random.default_rng(2)
    prior = (gts[ref] * (1 + 0.02 * rp.standard_normal(gts[ref].shape))).astype(np.float32)
    prior[rp.random(prior.shape) < 0.3] = 0.0
    data = densify._build_pm_data(
        scene.images[ref].gray, cam, [scene.images[j].gray for j in nbrs],
        [scene.images[j].working_camera() for j in nbrs], opts, 4.5, 7.5,
        prior, [gts[j] for j in nbrs], device=device)
    gt = torch.as_tensor(gts[ref], device=device)
    d = torch.where(gt > 0, gt, 6.0)
    rs = np.random.default_rng(0)
    factors = torch.as_tensor(np.linspace(0.97, 1.03, C), dtype=torch.float32,
                              device=device)
    depth = (d[None] * factors[:, None, None]).contiguous()
    tilt = torch.as_tensor(rs.normal(0, 0.15, (C, 1, 1, 2)), dtype=torch.float32,
                           device=device)
    normal = torch.cat([tilt.expand(C, *d.shape, 2),
                        -torch.ones(C, *d.shape, 1, device=device)], -1)
    normal = (normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)).contiguous()
    den = (normal * data.X0[None]).sum(-1) * depth
    inv_nd = torch.where(den.abs() > 1e-12, 1.0 / den, 0.0).contiguous()
    return data, opts, depth, normal, inv_nd


def _bound_geom(C, H, W, dm_px):
    """K3: the raw depth in and the penalty out, X0, uv, the neighbour depth
    map and 26 constants once each; FLOP_GEOM operations per (c, p)."""
    px = H * W
    cp = C * px
    nbytes = 4 * (dm_px + 26 + cp + 3 * px + 2 * px + cp)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = cp * FLOP_GEOM / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound_geom_views(C, H, W, V, dm_px):
    """K3-mv: the raw depths in and the (V, C, H, W) terms out, X0, uv, the
    V neighbour depth maps and 26 constants a view once each; FLOP_GEOM
    operations per (view, c, p)."""
    px = H * W
    cp = C * px
    nbytes = 4 * (V * (dm_px + 26) + cp + 3 * px + 2 * px + V * cp)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = V * cp * FLOP_GEOM / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _raw_depths(depth):
    """Raw candidate depths as the geometric kernels take them: ``depth``
    with 5% zeros, the invalid hypotheses."""
    import numpy as np
    import torch

    holes = torch.as_tensor(np.random.default_rng(1).random(depth.shape) < 0.05,
                            device=depth.device)
    return torch.where(holes, 0.0, depth).contiguous()


def _bound(C, H, W, T, img_px, dm_px, mode, geom):
    px = H * W
    cp = C * px
    nbytes = 4 * (img_px + cp * 5 + px * 3 + 2 * T * px + 2 * px + cp)
    flops = cp * (T * FLOP_TEXEL[mode] + FLOP_PIXEL)
    if geom:
        nbytes += 4 * (dm_px + 2 * px + cp)
        flops += cp * FLOP_GEOM
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound_views(C, H, W, T, V, img_px, dm_px, mode, geom):
    """The multi-view scorer: bytes are the weights once, the V images and
    26 constants a view, the candidate maps (depth, normal, inv_nd, bonus,
    delta: 7 floats a (c, p)), X0, sum_w, norm_sq0, f_blend and d0 (7 a
    pixel), and the output; fused adds the V depth maps and uv, precomputed
    the (V, C, H, W) terms. Operations are V x K1's per view, less the
    view-independent warp part counted once, plus finish_view per view and
    K2's geometric term per view when fused."""
    nbytes, flops = _views_work(C, H, W, T, V, img_px, dm_px, mode, geom)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _views_work(C, H, W, T, V, img_px, dm_px, mode, geom):
    """(bytes, fp32 operations) of ``_bound_views``."""
    px = H * W
    cp = C * px
    nbytes = 4 * (V * (img_px + 26) + 3 * T + 2 * T * px + 7 * cp + 7 * px + cp)
    flops = cp * (T * FLOP_SHARED + V * (T * (FLOP_TEXEL[mode] - FLOP_SHARED)
                                         + FLOP_PIXEL + FLOP_FINISH))
    if geom == "geom":
        nbytes += 4 * (V * dm_px + 2 * px)
        flops += cp * V * FLOP_GEOM
    elif geom == "pre":
        nbytes += 4 * V * cp
    return nbytes, flops


def _views_kernel_rows(card, scene, gts):
    """The multi-view scorer at the main path's operands (view 2 against its
    four neighbours, C=11 and C=1): each mode against score_views_plain on
    the card to the bit (NaN included) and against the per-view route it
    replaces (V launches of K1 or K2 plus the PyTorch epilogue), both timed
    in this call."""
    import torch

    from openmvs_tpu_torch.ops import patchmatch, pm_kernel

    dev = torch.device("cuda")
    rows = {}
    for C in (11, 1):
        data, opts, depth, normal, _ = _kernel_inputs(C, dev, scene, gts)
        v = data.views
        V = v.image.shape[0]
        H, W = depth.shape[1:]
        T = data.goff.shape[0]
        th = float(opts.th_robust)
        wg = float(opts.estimation_geometric_weight)
        state = patchmatch.PMState(depth=depth[C // 2], normal=normal[0],
                                   conf=torch.zeros_like(depth[0]))
        inv_nd, bonus, f_blend, delta = patchmatch.score_prelude(
            data, opts, state, depth, normal)
        args = (v.image, v.size, v.Hl, v.Hm, depth, normal, inv_nd, data.X0,
                data.goff, data.w, data.wtm, data.sum_w, data.norm_sq0, bonus,
                f_blend, delta, data.lowres)
        per_view_args = (data.X0, data.goff, data.w, data.wtm, data.sum_w,
                         data.norm_sq0)
        # K3-mv's terms, as the split sweep precomputes them
        terms = pm_kernel.geom_terms_plain(v.depth, v.size, v.Tl, v.Tm, v.Tr,
                                           v.Tn, depth, data.X0, data.uv)
        geom_kw = {"none": {}, "pre": {"geom_terms": terms},
                   "geom": {"Tr": v.Tr, "Tn": v.Tn, "dms": v.depth, "uv": data.uv}}
        for name, mode, geom in VIEW_KERNELS:
            nearest = mode == "nn"
            kw = dict(th_robust=th, geom_weight=wg, nearest=nearest, **geom_kw[geom])

            def kern():
                return pm_kernel.score_views(*args, **kw)

            def plain():
                return pm_kernel.score_views_plain(*args, **kw)

            def per_view(j, geom=geom, nearest=nearest):
                if geom == "geom":
                    return pm_kernel.score_view_geom(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j], v.Tn[j],
                        v.depth[j], depth, normal, inv_nd, data.X0, data.uv,
                        *per_view_args[1:], th_robust=th, nearest=nearest)
                s = pm_kernel.score_view(
                    v.image[j], v.size[j], v.Hl[j], v.Hm[j], depth, normal,
                    inv_nd, *per_view_args, th_robust=th, nearest=nearest)
                return s, terms[j] if geom == "pre" else None

            def old_route():
                return pm_kernel.finish_views(
                    per_view, V, v.size, bonus, f_blend, delta, data.lowres,
                    th_robust=th, geom_weight=wg)

            out_k = kern()
            out_o = old_route()
            torch.cuda.synchronize()
            out_p = plain()
            torch.cuda.synchronize()
            both_nan = torch.isnan(out_k) & torch.isnan(out_p)
            err = torch.where(both_nan, 0.0, (out_k - out_p).abs())
            rec = {"phase": "kernels", "name": name, "C": C, "V": V, "H": H,
                   "W": W, "T": T, "geom": geom,
                   "max_abs_err": float(err.max()),
                   "nan_share": float(torch.isnan(out_p).float().mean()),
                   "blended_share": float((data.lowres > 0).float().mean())}
            torch.testing.assert_close(out_k, out_p, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(out_k, out_o, rtol=0, atol=0, equal_nan=True)
            rec["equal_to_plain"] = rec["equal_to_per_view_route"] = True
            rec["ms"] = cuda_ms(kern, 20, graph=True)
            rec["eager_ms"] = cuda_ms(kern, 20)
            rec["per_view_route_ms"] = cuda_ms(old_route, 20, graph=True)
            rec["per_view_route_eager_ms"] = cuda_ms(old_route, 20)
            rec["speedup_graph"] = rec["per_view_route_ms"] / rec["ms"]
            rec["speedup_eager"] = rec["per_view_route_eager_ms"] / rec["eager_ms"]
            rec["plain_ms"] = cuda_ms(plain, 3)
            rec["library_ms"] = None
            rec["library_note"] = ("no single PyTorch call computes a "
                                   "plane-warped bilateral ZNCC over views")
            rec["bound_ms"], rec["bound_by"] = _bound_views(
                C, H, W, T, V, v.image[0].numel(), v.depth[0].numel(), mode, geom)
            rec["card"] = card
            emit(rec)
            rows[(name, C)] = rec
    return rows


def _geom_views_kernel_rows(card, scene, gts):
    """K3-mv at the split sweep's operands (view 2's raw candidate depths
    against its four neighbours, C=11 and C=1): against geom_terms_plain on
    the card to the bit (NaN included) and against the per-view route it
    replaces (V launches of K3 and torch.stack), both timed in this call."""
    import torch

    from openmvs_tpu_torch.ops import pm_kernel

    dev = torch.device("cuda")
    rows = {}
    for C in (11, 1):
        data, _, depth, _, _ = _kernel_inputs(C, dev, scene, gts)
        v = data.views
        V = v.depth.shape[0]
        H, W = depth.shape[1:]
        args = (v.depth, v.size, v.Tl, v.Tm, v.Tr, v.Tn, _raw_depths(depth),
                data.X0, data.uv)

        def kern():
            return pm_kernel.geom_terms(*args)

        def plain():
            return pm_kernel.geom_terms_plain(*args)

        def old_route():
            return torch.stack([pm_kernel.geom_term(*(a[j] for a in args[:6]), *args[6:])
                                for j in range(V)])

        out_k = kern()
        out_o = old_route()
        torch.cuda.synchronize()
        out_p = plain()
        torch.cuda.synchronize()
        both_nan = torch.isnan(out_k) & torch.isnan(out_p)
        rec = {"phase": "kernels", "name": "geom_terms", "C": C, "V": V, "H": H,
               "W": W, "max_abs_err": float(torch.where(both_nan, 0.0,
                                                        (out_k - out_p).abs()).max()),
               "consistent_share": float((out_p < 4.0).float().mean())}
        torch.testing.assert_close(out_k, out_p, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(out_k, out_o, rtol=0, atol=0, equal_nan=True)
        rec["equal_to_plain"] = rec["equal_to_per_view_route"] = True
        rec["ms"] = cuda_ms(kern, 20, graph=True)
        rec["eager_ms"] = cuda_ms(kern, 20)
        rec["per_view_route_ms"] = cuda_ms(old_route, 20, graph=True)
        rec["per_view_route_eager_ms"] = cuda_ms(old_route, 20)
        rec["speedup_graph"] = rec["per_view_route_ms"] / rec["ms"]
        rec["speedup_eager"] = rec["per_view_route_eager_ms"] / rec["eager_ms"]
        rec["plain_ms"] = cuda_ms(plain, 3)
        rec["library_ms"] = None
        rec["library_note"] = ("no single PyTorch call computes a forward-backward "
                               "reprojection penalty")
        rec["bound_ms"], rec["bound_by"] = _bound_geom_views(
            C, H, W, V, v.depth[0].numel())
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["card"] = card
        emit(rec)
        rows[("geom_terms", C)] = rec
    return rows


def _bound_splat(hw, valid):
    """(ms, "bytes" or "operations"): the least time of one splat on the
    card. Bytes: the source depths read and the layer of 64-bit words
    written, once. Operations: 66 float64 ones a valid source pixel (three
    3x3 products of 5 each and two rows of K, the depth's 3 products, the
    centres' 6 sums, 2 divisions; a fused multiply-add counts 2) at 34
    TFLOP/s."""
    b_ms, o_ms = hw * (4 + 8) / 3.35e12 * 1e3, 66 * valid / 34e12 * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _bound_decide(n_nb, hw, landed):
    """(ms, "bytes"): the least time of one view's decide: its depth and
    confidence, its n_nb layers of 64-bit words and one confidence for each
    word a depth landed in read, the new depth and confidence written."""
    return (2 * hw * 4 + n_nb * hw * 8 + landed * 4 + 2 * hw * 4) / 3.35e12 * 1e3, "bytes"


def _filter_kernel_rows(card):
    """The cross-view filter's kernels at the benchmark scene's shapes: the
    true depth maps of mvs_bench/scene_gen's 3x3 grid at 800x600 (its
    renderer, on the card), confidences and a tenth of the pixels dropped
    from a seed, view 4 against its 8 neighbours. The splat words and the
    decided maps against the plain twin on the card, bit for bit, and the
    whole filter of the 9 views (``filter_kernel.filter_views``) against
    the host NumPy filter (``densify._filter_views`` on the host's maps):
    the share of equal pixels. Times: one view's 8 splats and decide as a
    CUDA-graph replay and eagerly, each kernel's mean from the profiler,
    the twin on the card, the host's NumPy for the same view."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from mvs_bench import harness, scene_gen
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.geometry.camera import Camera
    from openmvs_tpu_torch.ops import filter_kernel as fk
    from openmvs_tpu_torch.ops import filters

    dev = torch.device("cuda")
    cfg = copy.deepcopy(harness.resolve("dtu-pm.scene").config)["scene"]
    W0, H0 = cfg["image_width"], cfg["image_height"]
    K0 = scene_gen.intrinsics(W0, H0)
    K = scene_gen.scale_intrinsics(K0, 0.5)
    rng = np.random.default_rng(7)
    results = {}
    Cs = scene_gen.grid_centers(cfg["grid"], cfg["spacing"])
    for i, C in enumerate(Cs):
        depth = scene_gen.ray_march(K, C, W0 // 2, H0 // 2, dev)[0].float().cpu().numpy()
        depth[rng.random(depth.shape) < 0.1] = 0.0
        conf = np.where(depth > 0, rng.uniform(0.1, 1.0, depth.shape), 0).astype(np.float32)
        results[i] = densify.DepthMapResult(
            image_idx=i, depth=depth, normal=None, conf=conf, d_min=1.0, d_max=20.0,
            neighbor_ids=[j for j in range(len(Cs)) if j != i],
            camera=Camera(K, np.eye(3), C), device=dev)
    opts = DenseOptions()
    ref = 4
    r = results[ref]
    h, w = r.depth.shape
    nbs = r.neighbor_ids
    maps = {k: (torch.from_numpy(v.depth).to(dev), torch.from_numpy(v.conf).to(dev))
            for k, v in results.items()}
    cam = {n: fk.cams(results[n].camera, r.camera) for n in nbs}
    fused = fk.blas_fuses()
    stack = torch.full((len(nbs), h, w), fk.EMPTY, dtype=torch.int64, device=dev)
    confs = [maps[n][1] for n in nbs]

    def splats():
        for j, n in enumerate(nbs):
            fk.splat(stack[j], maps[n][0], cam[n], fused)

    def view():
        splats()
        return fk.decide(stack, *maps[ref], confs, opts, r.d_min, r.d_max)

    def plain():
        twin = torch.full_like(stack, fk.EMPTY)
        for j, n in enumerate(nbs):
            fk.splat_plain(twin[j], maps[n][0], cam[n], fused)
        proj = [fk.unpack_plain(twin[j], confs[j]) for j in range(len(nbs))]
        return twin, torch.stack(fk.decide_plain(*maps[ref], proj, opts, r.d_min, r.d_max))

    torch.cuda.synchronize()
    splats()
    words = stack.clone()
    out = fk.decide(stack, *maps[ref], confs, opts, r.d_min, r.d_max)
    torch.cuda.synchronize()
    twin_words, twin_out = plain()
    splat_equal = bool(torch.equal(words, twin_words))
    decide_equal = bool(torch.equal(out.view(torch.int32), twin_out.view(torch.int32)))
    stack_clear = bool((stack == fk.EMPTY).all())
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card_maps = densify._filter_views(results, set(), opts)
    torch.cuda.synchronize()
    filter_s = time.perf_counter() - t0
    filter_peak = torch.cuda.max_memory_allocated() - base
    host_in = {k: dataclasses.replace(v, device=None) for k, v in results.items()}
    t0 = time.perf_counter()
    host_maps = densify._filter_views(host_in, set(), opts)
    host_s = time.perf_counter() - t0
    equal = sum(int((card_maps[k].depth.view(np.uint32) == host_maps[k].depth.view(np.uint32)).sum()
                    + (card_maps[k].conf.view(np.uint32) == host_maps[k].conf.view(np.uint32)).sum())
                for k in results)
    share = equal / (2 * h * w * len(results))
    t0 = time.perf_counter()
    for n in nbs:
        filters.project_depth_to_view(results[n].depth, results[n].conf, results[n].camera,
                                      r.camera, (h, w))
    host_splat_ms = (time.perf_counter() - t0) / len(nbs) * 1e3
    view_ms = cuda_ms(view, 20, graph=True)
    view_eager_ms = cuda_ms(view, 20)
    plain_ms = cuda_ms(plain, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            view()
        torch.cuda.synchronize()
    kern = _device_summary(prof, 8)["top"]
    per = {k: next((t["total_ms"] / t["count"] for t in kern if k in t["name"]), None)
           for k in ("filter_splat_kernel", "filter_decide_kernel")}
    valid = sum(int((results[n].depth > 0).sum()) for n in nbs)
    landed = int((words != fk.EMPTY).sum())
    s_bound, s_by = _bound_splat(h * w, valid / len(nbs))
    d_bound, d_by = _bound_decide(len(nbs), h * w, landed)
    bound, by = len(nbs) * s_bound + d_bound, "bytes" if s_by == d_by else "mixed"
    common = {"phase": "kernels", "H": h, "W": w, "neighbours": len(nbs),
              "blas_fuses": fused, "card": card}
    rec = dict(common, name="filter_view", ms=view_ms, eager_ms=view_eager_ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               splat_equal_twin=splat_equal, decide_equal_twin=decide_equal,
               stack_left_clear=stack_clear, kernel_ms=per,
               host_numpy_splat_ms=host_splat_ms,
               filter_9_views_s=filter_s, host_filter_9_views_s=host_s,
               filter_peak_bytes=filter_peak, equal_to_host_share=share,
               launches_per_job=len(results) * (len(nbs) + 1) + 1)
    emit(rec)
    if not (splat_equal and decide_equal and stack_clear) or share < 0.9999:
        raise RuntimeError(f"the filter kernels disagree: {rec}")
    rows = {"filter_view": dict(rec, max_abs_err=0.0)}
    rows["filter_splat"] = dict(rec, ms=per["filter_splat_kernel"], plain_ms=plain_ms,
                                bound_ms=s_bound, bound_by=s_by, max_abs_err=0.0)
    rows["filter_decide_adjust"] = dict(rec, ms=per["filter_decide_kernel"],
                                        bound_ms=d_bound, bound_by=d_by, max_abs_err=0.0)
    return rows


def fusion_views(grid, n_views, seed, device, W=800, H=600):
    """``n_views`` views of mvs_bench/scene_gen's ``grid`` x ``grid``
    layout at the benchmark's level-1 size as fusion's input: true depths
    (a tenth of the pixels dropped), the surface's normals in each camera's
    frame facing it, confidences and colours from ``seed``; each view's
    neighbours every other view. Phase kernels and
    tests/test_torch_fusion_card.py fuse them."""
    import numpy as np
    import torch

    from mvs_bench import harness, scene_gen
    from openmvs_tpu_torch.geometry.camera import Camera
    from openmvs_tpu_torch.ops import fusion

    cfg = harness.resolve("dtu-pm.scene").config["scene"]
    K = scene_gen.scale_intrinsics(scene_gen.intrinsics(cfg["image_width"], cfg["image_height"]),
                                   W / cfg["image_width"])
    rng = np.random.default_rng(seed)
    centres = scene_gen.grid_centers(grid, cfg["spacing"])[:n_views]
    views = []
    for i, C in enumerate(centres):
        depth, x, y = scene_gen.ray_march(K, C, W, H, device)
        xs, ys = x.detach().requires_grad_(), y.detach().requires_grad_()
        gx, gy = torch.autograd.grad(scene_gen.height(xs, ys).sum(), (xs, ys))
        n = torch.stack([gx, gy, -torch.ones_like(gx)], -1)
        n = (n / n.norm(dim=-1, keepdim=True)).float().cpu().numpy()
        d = depth.float().cpu().numpy()
        d[rng.random(d.shape) < 0.1] = 0.0
        conf = np.where(d > 0, rng.uniform(0.1, 1.0, d.shape), 0).astype(np.float32)
        colour = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        views.append(fusion.ViewDepthData(
            i, i, Camera(K, np.eye(3), C), d, np.ascontiguousarray(n), conf, colour,
            [j for j in range(len(centres)) if j != i]))
    return views


def _same_cloud(a, b) -> bool:
    import numpy as np

    return (a.points.view(np.uint32).tobytes() == b.points.view(np.uint32).tobytes()
            and a.colors.tobytes() == b.colors.tobytes()
            and a.normals.view(np.uint32).tobytes() == b.normals.view(np.uint32).tobytes()
            and len(a.views) == len(b.views)
            and all(x.dtype == y.dtype and np.array_equal(x, y)
                    for x, y in zip(a.views, b.views))
            and all(x.dtype == y.dtype and np.array_equal(x.view(np.uint32), y.view(np.uint32))
                    for x, y in zip(a.weights, b.weights)))


def _bound_fusion(px, n_points, n_members, n_nb):
    """(ms, "bytes" or "operations"): the least time of one 9-view fusion
    on the card. Bytes: every map read once (depth, confidence, owner 4 B
    each, the normal 12, the colour 3: 27 B a pixel), every point written
    once (point and normal 12 B each, colour 3, count 4) and every member
    (view id and weight, 8 B). Operations: at least one candidate a point,
    each projected into n_nb neighbours (80 float64 operations: the
    projection's two 3x3 products and K's rows, 5 each with a fused
    multiply-add counted 2, the divides, the depth and normal tests) at 34
    TFLOP/s."""
    b_ms = (px * 27 + n_points * 31 + n_members * 8) / 3.35e12 * 1e3
    o_ms = n_points * n_nb * 80 / 34e12 * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


FUSE_KERNELS = ("fuse_claim_kernel", "fuse_count_kernel", "fuse_carry_kernel",
                "fuse_keep_kernel", "fuse_emit_kernel")


def _fusion_kernel_rows(card):
    """Fusion's kernels on the phase's scene (``fusion_views``: the 3x3
    grid's 9 views at 800x600): the kernels' cloud against the plain twin
    (``fuse_views`` on the CPU) and the host NumPy fusion, bit for bit; one
    row for the whole job: its device time (every launch of one 9-view
    fusion, the profiler's means), the twin's and the bound, each for the
    job; per kernel its mean time; the wall time of ``fuse_views``
    (upload, launches, download and the per-point lists) against the
    host's."""
    import torch

    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import fusion
    from openmvs_tpu_torch.ops import fusion_kernel as fk

    dev = torch.device("cuda")
    views = fusion_views(3, 9, 7, dev)
    opts = DenseOptions(min_views_fuse=3)
    fk.fuse_views(views, opts, device=dev)  # the build and the first launches
    before = dict(fk.LAUNCHES)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = fk.fuse_views(views, opts, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k: (v - before[k]) // 3 for k, v in fk.LAUNCHES.items()}
    t0 = time.perf_counter()
    twin = fk.fuse_views(views, opts, device="cpu")
    twin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = fusion.fuse_depth_maps(views, opts)
    host_s = time.perf_counter() - t0
    equal_twin, equal_host = _same_cloud(got, twin), _same_cloud(got, host)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fk.fuse_views(views, opts, device=dev)
        torch.cuda.synchronize()
    kern = _device_summary(prof, 40)["top"]
    per = {k: next(((t["total_ms"] / t["count"], t["count"] // 3) for t in kern
                    if k in t["name"]), (None, 0)) for k in FUSE_KERNELS}
    job_ms = sum(ms * n for ms, n in per.values() if ms is not None)
    px = sum(v.depth.size for v in views)
    members = sum(len(v) for v in host.views)
    bound, by = _bound_fusion(px, len(host), members, len(views) - 1)
    rec = {"phase": "kernels", "name": "fuse_views", "H": views[0].depth.shape[0],
           "W": views[0].depth.shape[1], "views": len(views), "neighbours": len(views) - 1,
           "points": len(host), "members": members, "blas_fuses": fk.blas_fuses(),
           "sum_orders": fk.sum_orders(), "equal_twin": equal_twin, "equal_host": equal_host,
           "kernel_ms": {k: ms for k, (ms, _) in per.items()},
           "launches_per_job": launches, "ms": job_ms, "plain_ms": twin_s * 1e3,
           "bound_ms": bound, "bound_by": by, "fuse_views_wall_s": walls,
           "host_numpy_s": host_s, "card": card}
    emit(rec)
    if not (equal_twin and equal_host):
        raise RuntimeError(f"the fusion kernels disagree: {rec}")
    return {"fuse_views": dict(rec, max_abs_err=0.0)}


def phase_kernels(card, scene, gts):
    import torch

    from openmvs_tpu_torch.ops import pm_kernel

    dev = torch.device("cuda")
    rows = _views_kernel_rows(card, scene, gts)
    rows.update(_geom_views_kernel_rows(card, scene, gts))
    rows.update(_filter_kernel_rows(card))
    rows.update(_fusion_kernel_rows(card))
    for C in (11, 1):
        data, opts, depth, normal, inv_nd = _kernel_inputs(C, dev, scene, gts)
        v = data.views
        H, W = depth.shape[1:]
        T = data.goff.shape[0]
        th = float(opts.th_robust)
        j = 0
        common = (data.X0, data.goff, data.w, data.wtm, data.sum_w, data.norm_sq0)
        scorer = (v.image[j], v.size[j], v.Hl[j], v.Hm[j], depth, normal, inv_nd,
                  *common)
        geom = (v.depth[j], v.size[j], v.Tl[j], v.Tm[j], v.Tr[j], v.Tn[j],
                _raw_depths(depth), data.X0, data.uv)
        for name, mode, kind in KERNELS:
            nearest = mode == "nn"
            if kind == "k2":
                def kern():
                    return pm_kernel.score_view_geom(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j], v.Tn[j],
                        v.depth[j], depth, normal, inv_nd, data.X0, data.uv,
                        *common[1:], th_robust=th, nearest=nearest)

                def plain():
                    s, _ = pm_kernel.score_view_plain(*scorer, th_robust=th,
                                                      nearest=nearest)
                    return s, pm_kernel.geom_term_plain(
                        v.depth[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j],
                        v.Tn[j], depth, data.X0, data.uv)
            elif kind == "k3":
                def kern():
                    return (None, pm_kernel.geom_term(*geom))

                def plain():
                    return (None, pm_kernel.geom_term_plain(*geom))
            else:
                fn = pm_kernel.score_view_v2 if kind == "v2" else pm_kernel.score_view

                def kern(fn=fn):
                    return (fn(*scorer, th_robust=th, nearest=nearest),)

                def plain():
                    return (pm_kernel.score_view_plain(*scorer, th_robust=th,
                                                       nearest=nearest)[0],)
            out_k = kern()
            torch.cuda.synchronize()
            out_p = plain()
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "name": name, "C": C, "H": H, "W": W, "T": T}
            good = True
            max_err = 0.0
            if kind != "k3":
                d_s = (out_k[0] - out_p[0]).abs()[depth > 0]
                within = float((d_s < 1e-3).float().mean())
                rec["score_max_abs_err"] = float(d_s.max())
                rec["score_share_within_1e-3"] = within
                good = within >= 0.999 and float(d_s.max()) < 1e-2
                max_err = float(d_s.max())
            if kind in ("k2", "k3"):
                d_c = (out_k[1] - out_p[1]).abs()
                rec["cons_max_abs_err"] = float(d_c.max())
                rec["cons_share_within_1e-3"] = float((d_c < 1e-3).float().mean())
                good = good and rec["cons_share_within_1e-3"] >= 0.995
                max_err = max(max_err, float(d_c.max()))
            if kind == "v2":
                k1 = pm_kernel.score_view(*scorer, th_robust=th, nearest=nearest)
                in_win = torch.empty(depth.shape, dtype=torch.uint8, device=dev)
                pm_kernel.score_view_v2(*scorer, th_robust=th, nearest=nearest,
                                        in_window=in_win)
                rec["equal_to_k1"] = bool(torch.equal(out_k[0], k1))
                rec.update(_window_shares(in_win, scorer, th, nearest))
                good = good and rec["equal_to_k1"]
            rec["ms"] = cuda_ms(kern, 20, graph=True)
            rec["eager_ms"] = cuda_ms(kern, 20)
            rec["plain_ms"] = cuda_ms(plain, 3)
            rec["library_ms"] = None
            rec["library_note"] = (
                "no single PyTorch call computes a forward-backward "
                "reprojection penalty" if kind == "k3" else
                "no single PyTorch call computes a plane-warped bilateral ZNCC")
            if kind == "k3":
                bound, by = _bound_geom(C, H, W, v.depth[j].numel())
            else:
                bound, by = _bound(C, H, W, T, v.image[j].numel(),
                                   v.depth[j].numel(), mode, kind == "k2")
            rec["bound_ms"] = bound
            rec["bound_by"] = by
            rec["card"] = card
            emit(rec)
            if not good:
                raise RuntimeError(f"{name} at C={C} disagrees with its plain "
                                   "version (or K1-v2 with K1)")
            rows[(name, C)] = dict(rec, max_abs_err=max_err)
    return rows


def _window_shares(in_win, scorer, th, nearest):
    """K1-v2's staged-window share over all (candidate, pixel)s, the share
    whose texels all warp inside the view (only those texels bound the
    window), and the window share among those."""
    from openmvs_tpu_torch.ops import pm_kernel

    inb = pm_kernel.score_view_plain(*scorer, th_robust=th, nearest=nearest)[1]
    win = in_win.bool()
    return {"in_window_share": float(win.float().mean()),
            "in_bounds_share": float(inb.float().mean()),
            "in_window_share_of_in_bounds":
                float((win & inb).sum()) / max(float(inb.sum()), 1.0)}


def phase_variants(card):
    """K1 against K1-v2 on the dev script's inputs (the comparison of the
    JAX package's scripts/dev_kernel_variants.py main), timed in turns
    K1, K1-v2, K1-v2, K1. Then the same where K1-v2's window cannot hold
    every footprint: the candidate depths spread from [3, 3.5] to [1, 4],
    so the disparities within a tile span 32-128 pixels, wider than the
    64-column window, and K1-v2 re-reads the in-bounds (candidate, pixel)s
    that miss it from the image. Only the first run's launches count."""
    import numpy as np

    from openmvs_tpu_torch.ops import kernel_variants, pm_kernel

    ins = kernel_variants.make_inputs()
    pm_kernel.reset_launches()
    _variants_rows(card, kernel_variants.as_args(ins, "cuda"), "dev")
    launches = dict(pm_kernel.LAUNCHES)
    if launches["score_view_v2_exact"] == 0 or launches["score_view_v2_nn"] == 0:
        raise RuntimeError(f"K1-v2 was not launched: {launches}")
    depth = ins["depth"] * np.float32(6) - np.float32(17)
    den = np.einsum("chwk,hwk->chw", ins["normal"], ins["X0"]) * depth
    inv_nd = np.where(np.abs(den) > 1e-12, 1.0 / den, 0.0).astype(np.float32)
    spread = kernel_variants.as_args(dict(ins, depth=depth, inv_nd=inv_nd), "cuda")
    for rec in _variants_rows(card, spread, "depths 1-4"):
        if rec["in_window_share_of_in_bounds"] >= 1.0:
            raise RuntimeError(f"K1-v2 ({rec['mode']}): no in-bounds footprint left "
                               "the window, so its re-read from the image did not run")
    return launches


def _variants_rows(card, args, inputs):
    """Per sampling mode, K1 and K1-v2 on ``args`` (K1's operands on the
    card): times in turns, torch.equal, and K1-v2's window shares."""
    import torch

    from openmvs_tpu_torch.ops import pm_kernel

    C, H, W = args[4].shape
    rows = []
    for mode in ("exact", "nn"):
        nearest = mode == "nn"

        def k1():
            return pm_kernel.score_view(*args, th_robust=1.2, nearest=nearest)

        def v2():
            return pm_kernel.score_view_v2(*args, th_robust=1.2, nearest=nearest)

        in_win = torch.empty((C, H, W), dtype=torch.uint8, device="cuda")
        s2 = pm_kernel.score_view_v2(*args, th_robust=1.2, nearest=nearest,
                                     in_window=in_win)
        s1 = k1()
        torch.cuda.synchronize()
        t = [cuda_ms(k1, 20), cuda_ms(v2, 20), cuda_ms(v2, 20), cuda_ms(k1, 20)]
        rec = {"phase": "variants", "inputs": inputs, "mode": mode, "C": C,
               "H": H, "W": W, "T": args[8].shape[0], "k1_ms": [t[0], t[3]],
               "k1_v2_ms": [t[1], t[2]], "equal": bool(torch.equal(s1, s2)),
               **_window_shares(in_win, args, 1.2, nearest),
               "scored_share": float((s1 < 1.19).float().mean()), "card": card}
        emit(rec)
        if not rec["equal"]:
            raise RuntimeError(f"K1-v2 ({mode}) differs from K1 on the {inputs} inputs")
        rows.append(rec)
    return rows


class _StageLog(logging.Handler):
    """Collects a logger's timed stages ("label (1.23s)") and messages."""

    def __init__(self):
        super().__init__()
        self.stages = {}
        self.messages = []

    def emit(self, record):
        msg = record.getMessage()
        self.messages.append(msg)
        m = re.match(r"(.*) \(([0-9.]+)s\)$", msg)
        if m:
            self.stages[m.group(1)] = float(m.group(2))


def _dmaps(folder, n, fields=("depth",)):
    """The saved maps of views 0 to n - 1: each one array, or with several
    ``fields`` a tuple of them."""
    from openmvs_tpu_torch.io import dmap

    out = []
    for i in range(n):
        dd = dmap.load(os.path.join(folder, f"depth{i:04d}.dmap"))
        got = tuple(getattr(dd, f) for f in fields)
        out.append(got if len(fields) > 1 else got[0])
    return out


@contextlib.contextmanager
def _scoring_calls():
    """Counts the calls of patchmatch.score_hypotheses in the block (a
    one-element list). A call made while a sweep's CUDA graph is captured
    counts at each replay of the graph (pm_kernel.host_effect), as its
    launch does."""
    from openmvs_tpu_torch.ops import patchmatch, pm_kernel

    score = patchmatch.score_hypotheses
    calls = [0]

    def one():
        calls[0] += 1

    def counted(*a, **kw):
        pm_kernel.host_effect(one)
        return score(*a, **kw)

    patchmatch.score_hypotheses = counted
    try:
        yield calls
    finally:
        patchmatch.score_hypotheses = score


@contextlib.contextmanager
def _graph_runners():
    """The graphs.Runners made in the block (the sweep graphs of each
    densify call), kept alive until it ends."""
    from openmvs_tpu_torch.ops import graphs

    made = []
    cls = graphs.Runners

    class Recorded(cls):
        def __init__(self):
            super().__init__()
            made.append(self)

        def release(self):
            # a call releases its runners when it returns: keep what they
            # held for the summary
            self.held = {"classes": sum(r.n_classes for r in self.all()),
                         "pool_bytes": sum(r.pool_bytes() for r in self.all())}
            super().release()

    graphs.Runners = Recorded
    try:
        yield made
    finally:
        graphs.Runners = cls
        # the list and the class's closure form a cycle: break it, so the
        # graphs go when the caller drops them, never in a later capture
        made.clear()


def _graph_summary(runners_list):
    """Captures, their seconds, replays and the graph pools' bytes (the
    card's segments of each runner's pool) of graphs.Runners objects; a
    released one's classes and bytes as it held them before it let go."""
    runners = [r for rs in runners_list for r in rs.all()]
    return {"runners": len(runners), "captures": sum(r.captures for r in runners),
            "capture_s": sum(r.capture_s for r in runners),
            "replays": sum(r.replays for r in runners),
            "classes": sum(getattr(rs, "held", {}).get("classes", 0) for rs in runners_list)
            + sum(r.n_classes for r in runners),
            "pool_bytes": sum(getattr(rs, "held", {}).get("pool_bytes", 0)
                              for rs in runners_list)
            + sum(r.pool_bytes() for r in runners)}


def _run_densify(scene, device="cuda", env=None, eager=False):
    """dense_reconstruction(scene, DenseOptions()) on ``device`` with the
    launch counts set to 0 just before and read just after, and ``env``
    set around it only; ``eager`` launches the sweeps one by one instead of
    replaying their graphs: (cloud, depth maps, wall s, launches, stage s,
    calls of patchmatch.score_hypotheses, extra), extra holding each
    view's (depth, normal, conf) and, on the card, the graph summary."""
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import filter_kernel, fusion_kernel, pm_kernel

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    stage_log = _StageLog()
    logger = logging.getLogger("omvs_torch.densify")
    logger.addHandler(stage_log)
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory() as tmp, _scoring_calls() as calls, \
                _graph_runners() as made:
            pm_kernel.reset_launches()
            filter0 = dict(filter_kernel.LAUNCHES)
            fuse0 = dict(fusion_kernel.LAUNCHES)
            t0 = time.perf_counter()
            pc = densify.dense_reconstruction(scene, DenseOptions(), save_dmaps_to=tmp,
                                              device=device, _eager=eager)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(pm_kernel.LAUNCHES)
            launches.update({k: v - filter0[k] for k, v in filter_kernel.LAUNCHES.items()})
            launches["fuse_views"] = sum(v - fuse0[k] for k, v in fusion_kernel.LAUNCHES.items())
            full = _dmaps(tmp, len(scene.images), ("depth", "normal", "conf"))
            extra = {"maps": full,
                     "graphs": _graph_summary(made) if device == "cuda" else None}
    finally:
        logger.removeHandler(stage_log)
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
    return pc, [m[0] for m in full], wall, launches, stage_log.stages, calls[0], extra


def _check_scoring(launches, calls):
    """One multi-view scorer launch per score_hypotheses call, and no
    per-view K1/K2 launch."""
    views = sum(n for k, n in launches.items() if k.startswith("score_views_"))
    if views != calls or any(launches[k] for k in PER_VIEW):
        raise RuntimeError(f"{calls} score_hypotheses calls but launches {launches}: "
                           "expected one multi-view launch each and no per-view K1/K2")


def _agreement(maps_a, maps_b):
    """Per view: valid-mask agreement, depth agreement to 1e-3 relative on
    the pixels valid in both, and the bit-identical share."""
    import numpy as np

    mask_agree, depth_agree, identical = [], [], []
    for a, b in zip(maps_a, maps_b):
        va, vb = a > 0, b > 0
        mask_agree.append(float((va == vb).mean()))
        both = va & vb
        rel = np.abs(a - b)[both] / b[both]
        depth_agree.append(float((rel < 1e-3).mean()) if both.any() else 1.0)
        identical.append(float((a == b).mean()))
    return mask_agree, depth_agree, identical


def _check_quality(q):
    for i, (acc, comp) in enumerate(q):
        if acc < 0.95 * JAX_ACCURACY[i] or comp < 0.95 * JAX_COMPLETENESS[i]:
            raise RuntimeError(f"view {i}: quality {(acc, comp)} below 95% of the "
                               f"JAX package's ({JAX_ACCURACY[i]}, {JAX_COMPLETENESS[i]})")


def _pass_seconds(stages):
    """(photometric, geometric, estimation) seconds of a densify stage log
    (10 ms resolution)."""
    photo = sum(v for k, v in stages.items() if k.startswith("photometric pass"))
    geo = sum(v for k, v in stages.items() if k.startswith("geometric pass"))
    return photo, geo, photo + geo


def _same_maps(a, b):
    """Per view, whether two runs' (depth, normal, conf) are equal to the
    bit."""
    import numpy as np

    return [all(np.array_equal(x, y, equal_nan=True) for x, y in zip(ma, mb))
            for ma, mb in zip(a, b)]


def _same_cloud(a, b):
    import numpy as np

    return (len(a) == len(b) and np.array_equal(a.points, b.points)
            and all(np.array_equal(x, y) for x, y in zip(a.views, b.views))
            and all(np.array_equal(x, y) for x, y in zip(a.weights, b.weights)))


def phase_densify(card, scene, gts, t_scene):
    """The main path, its sweeps replayed as CUDA graphs, then the same call
    with the sweeps launched one by one: the graphed run's maps and cloud
    equal the eager run's bit for bit, with the same kernel launches."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import depth_quality

    n = len(scene.images)
    opts = DenseOptions()
    pc, maps, wall, launches, stages, calls, extra = _run_densify(scene)
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    n_nbrs = [len(im.meta.view_scores) for im in scene.images]
    n_maps = n * (1 + opts.estimation_geometric_iters)
    # estimation alone (photometric and geometric passes, as bench.py of the
    # JAX package counts depth maps)
    photo_s, geo_s, est_s = _pass_seconds(stages)
    pc_e, _, wall_e, launches_e, stages_e, calls_e, extra_e = _run_densify(scene, eager=True)
    photo_e, geo_e, est_e = _pass_seconds(stages_e)
    same = _same_maps(extra["maps"], extra_e["maps"])
    same_cloud = _same_cloud(pc, pc_e)
    rec = {"phase": "densify", "views": n, "H": 480, "W": 640,
           "depth_maps": n_maps, "wall_s": wall,
           "depth_maps_per_s": n_maps / wall, "estimate_s": est_s,
           "estimate_depth_maps_per_s": n_maps / est_s if est_s else None,
           "photometric_s": photo_s, "geometric_s": geo_s,
           "stages_s": stages, "graphs": extra["graphs"],
           "eager": {"wall_s": wall_e, "photometric_s": photo_e, "geometric_s": geo_e,
                     "estimate_s": est_e, "stages_s": stages_e,
                     "score_hypotheses_calls": calls_e},
           "graphed_over_eager": {"wall": wall / wall_e, "photometric": photo_s / photo_e,
                                  "geometric": geo_s / geo_e},
           "maps_equal_eager": same, "points_equal_eager": same_cloud,
           "scene_build_s": t_scene, "points": len(pc), "eager_points": len(pc_e),
           "launches": launches, "score_hypotheses_calls": calls,
           "neighbors_per_view": n_nbrs,
           "accuracy": [a for a, _ in q], "completeness": [c for _, c in q],
           "jax_accuracy": JAX_ACCURACY, "jax_completeness": JAX_COMPLETENESS,
           "card": card}
    emit(rec)
    if any(launches[k] == 0 for k in MAIN_PATH):
        raise RuntimeError(f"a scorer kernel was not launched on the main path: {launches}")
    _check_scoring(launches, calls)
    _check_scoring(launches_e, calls_e)
    if launches != launches_e:
        raise RuntimeError(f"graphed launches {launches}, eager {launches_e}")
    if not (all(same) and same_cloud):
        raise RuntimeError(f"graphed and eager densify differ: maps equal {same}, "
                           f"points equal {same_cloud} ({len(pc)} and {len(pc_e)})")
    if not (extra["graphs"]["captures"] and extra["graphs"]["replays"]):
        raise RuntimeError(f"the sweeps ran without graphs: {extra['graphs']}")
    # per depth map: K1-mv <= 12 per pyramid level, K2-mv = 3 per geometric
    # map (the incumbent and two parities)
    k1 = launches["score_views_exact"] + launches["score_views_nn"]
    k2 = launches["score_views_geom_exact"] + launches["score_views_geom_nn"]
    geo_expected = opts.estimation_geometric_iters * 3 * n
    if k2 != geo_expected:
        raise RuntimeError(f"K2-mv launches {k2} != {geo_expected}")
    if k1 > (opts.sub_resolution_levels + 1) * 12 * n:
        raise RuntimeError(f"K1-mv launches {k1} above 12 per map and level")
    if len(pc) == 0:
        raise RuntimeError("empty dense cloud")
    _check_quality(q)
    return launches, maps, pc, wall


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _device_summary(prof, top_n, skip=()):
    """The CUDA events of a torch.profiler run: their count, kernel
    launches (events less copies and sets), copies, device-busy seconds
    (the union of their spans), the seconds from the first event's start
    to the last one's end, and the ``top_n`` names by total time.
    ``skip`` names events to leave out: a record_function range also
    appears on the device timeline, spanning the kernels it launched."""
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.name not in skip]
    by_name = {}
    for e in dev_events:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    copies = sum(cnt for name, (_, cnt) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    busy_s = _union_us([(e.time_range.start, e.time_range.end)
                        for e in dev_events]) / 1e6
    span_s = ((max(e.time_range.end for e in dev_events)
               - min(e.time_range.start for e in dev_events)) / 1e6 if dev_events else 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"events": len(dev_events), "launches": len(dev_events) - copies,
            "copies": copies, "busy_s": busy_s, "span_s": span_s,
            "top": [{"name": name[:160], "total_ms": tot / 1e3, "count": cnt,
                     "share_of_busy": tot / 1e6 / busy_s}
                    for name, (tot, cnt) in top] if busy_s else []}


# the host's CUDA calls that launch one kernel each
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def _host_calls(prof):
    """The CUDA API calls (``cuda*`` and ``cu*``) the host made in a
    torch.profiler run, by name."""
    from torch.autograd import DeviceType

    calls = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cu"):
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def phase_profile(card, scene):
    """One view's photometric estimate_depth_map (view 0, 480x640, the
    3-level pyramid), eager and with its sweeps replayed as CUDA graphs
    (captured by a first call, which is timed), each under torch.profiler
    with CUDA activity after one unprofiled run of the same call: per mode
    the seconds, sweeps, device-busy share, kernels run on the device, the
    host's kernel launches and graph replays (its CUDA calls in the trace),
    copies, host synchronisations, the top 10 device kernels by total time,
    and host time per sweep outside the kernels (the unprofiled wall less
    the device-busy time, over the sweeps run); graphed, the captures, their
    seconds and the graph pool's bytes. The graphed map equals the eager
    one. Reads the view selection phase densify made."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import graphs, patchmatch, pm_kernel

    opts = DenseOptions()
    counts = {"half_steps": 0}
    sweep_parity = patchmatch._sweep_parity

    def one():
        counts["half_steps"] += 1

    def counted(*a, **kw):
        pm_kernel.host_effect(one)
        return sweep_parity(*a, **kw)

    def run(**kw):
        t0 = time.perf_counter()
        r = densify.estimate_depth_map(scene, 0, opts, device="cuda", **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    runners = graphs.Runners()
    modes, maps = {}, {}
    torch.cuda.synchronize()
    patchmatch._sweep_parity = counted
    try:
        _, first_s = run(runners=runners)
        for name, kw in (("eager", {"_eager": True}), ("graphed", {"runners": runners})):
            counts["half_steps"] = 0
            maps[name], wall = run(**kw)
            sweeps = counts["half_steps"] / 2
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall_profiled = run(**kw)
            dev = _device_summary(prof, 10)
            api = _host_calls(prof)
            busy_s = dev["busy_s"]
            modes[name] = {
                "wall_s": wall, "wall_profiled_s": wall_profiled, "sweeps": sweeps,
                "device_busy_s": busy_s,
                "device_busy_share_of_profiled": busy_s / wall_profiled,
                "device_busy_share": min(busy_s / wall, 1.0),
                # from the first device event to the last: the host's work
                # before the first upload (seeds) left out
                "device_busy_share_of_span": busy_s / dev["span_s"],
                "kernels_run_on_device": dev["launches"], "device_copies": dev["copies"],
                "host_kernel_launches": sum(api.get(k, 0) for k in LAUNCH_APIS),
                "graph_replays": api.get("cudaGraphLaunch", 0),
                "host_copies": api.get("cudaMemcpyAsync", 0),
                "host_syncs": sum(api.get(k, 0) for k in (
                    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")),
                "host_s_per_sweep_outside_kernels": (wall - busy_s) / sweeps,
                "top10_kernels": dev["top"]}
        summary = _graph_summary([runners])
    finally:
        patchmatch._sweep_parity = sweep_parity
    same = _same_maps([[getattr(maps["graphed"], f) for f in ("depth", "normal", "conf")]],
                      [[getattr(maps["eager"], f) for f in ("depth", "normal", "conf")]])
    g, e = modes["graphed"], modes["eager"]
    rec = {"phase": "profile", "view": 0, "H": 480, "W": 640,
           "graphed_first_call_s": first_s, "graphs": summary, **modes,
           "graphed_over_eager_s": g["wall_s"] / e["wall_s"],
           "map_equal_eager": same[0], "card": card}
    emit(rec)
    if not same[0]:
        raise RuntimeError("the graphed photometric map differs from the eager one")
    if not g["graph_replays"] or g["host_kernel_launches"] >= e["host_kernel_launches"]:
        raise RuntimeError(f"graphed: {g['graph_replays']} replays, "
                           f"{g['host_kernel_launches']} host launches against "
                           f"{e['host_kernel_launches']} eager")
    if np.isnan(g["device_busy_share"]):
        raise RuntimeError("the profiler saw no device time")
    return rec


def phase_geom_split(card, scene, gts, default_maps, default_launches):
    """The densify path with geometric sweeps split (OMVS_GEOM_SPLIT=1):
    per geometric map K2-mv scores the incumbent once (init), and per
    parity K3-mv runs once for all neighbour views, then the scorer once
    with the terms precomputed; the per-view K3 never."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import depth_quality

    n = len(scene.images)
    opts = DenseOptions()
    pc, maps, wall, launches, stages, calls, _ = _run_densify(
        scene, env={"OMVS_GEOM_SPLIT": "1"})
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    mask_agree, depth_agree, identical = _agreement(maps, default_maps)
    geo = opts.estimation_geometric_iters
    n_maps = n * (1 + geo)
    expected = {"geom_terms": geo * 2 * n, "geom_term": 0,
                "score_views_geom_exact": geo * n,
                "score_views_pre_exact": geo * 2 * n,
                "score_views_exact": default_launches["score_views_exact"],
                "score_views_nn": default_launches["score_views_nn"]}
    est_s = sum(v for k, v in stages.items()
                if k.startswith(("photometric pass", "geometric pass")))
    rec = {"phase": "geom_split", "views": n, "H": 480, "W": 640,
           "depth_maps": n_maps, "wall_s": wall, "depth_maps_per_s": n_maps / wall,
           "estimate_s": est_s, "stages_s": stages, "points": len(pc),
           "launches": launches, "expected_launches": expected,
           "score_hypotheses_calls": calls,
           "accuracy": [a for a, _ in q], "completeness": [c for _, c in q],
           "mask_agreement_with_densify": mask_agree,
           "depth_agreement_with_densify": depth_agree,
           "bit_identical_with_densify": identical, "card": card}
    emit(rec)
    _check_scoring(launches, calls)
    if any(launches[k] != want for k, want in expected.items()):
        raise RuntimeError(f"split launches {launches}, expected {expected}")
    if min(mask_agree) < 0.999 or min(depth_agree) < 0.999:
        raise RuntimeError("split and default depth maps disagree")
    _check_quality(q)
    return launches


def phase_parity(card):
    from openmvs_tpu_torch.synthetic import build_gt_scene

    n = 5
    out = {}
    for dev in ("cuda", "cpu"):
        scene, _, _ = build_gt_scene(n_views=n, W=160, H=120)
        pc, maps, wall, _, _, _, _ = _run_densify(scene, dev)
        out[dev] = (len(pc), maps, wall)
    mask_agree, depth_agree, identical = _agreement(out["cuda"][1], out["cpu"][1])
    pts = (out["cuda"][0], out["cpu"][0])
    rec = {"phase": "parity", "H": 120, "W": 160, "points_cuda": pts[0],
           "points_cpu": pts[1], "mask_agreement": mask_agree,
           "depth_agreement": depth_agree, "bit_identical": identical,
           "cuda_s": out["cuda"][2],
           "cpu_s": out["cpu"][2], "card": card}
    emit(rec)
    if min(mask_agree) <= 0.99 or min(depth_agree) <= 0.99:
        raise RuntimeError("card and CPU depth maps disagree")
    if abs(pts[0] - pts[1]) > 0.02 * max(pts[1], 1):
        raise RuntimeError(f"point counts differ by more than 2%: {pts}")
    return out["cuda"][1]


def phase_geom_unfused(card, default_maps):
    """The 120x160 scene on the card with geometric scoring unfused
    (OMVS_GEOM_FUSED=0: K3-mv for all views, then the scorer with the terms
    precomputed, in place of K2-mv), against the default run of phase
    parity."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    n = 5
    scene, _, _ = build_gt_scene(n_views=n, W=160, H=120)
    pc, maps, wall, launches, _, calls, _ = _run_densify(
        scene, env={"OMVS_GEOM_FUSED": "0"})
    mask_agree, depth_agree, identical = _agreement(maps, default_maps)
    # per geometric map: the incumbent (C=1) and two parities, one K3-mv
    # launch and one precomputed-mode launch each
    geo = DenseOptions().estimation_geometric_iters
    k3_expected = pre_expected = geo * 3 * n
    k2 = launches["score_views_geom_exact"] + launches["score_views_geom_nn"]
    rec = {"phase": "geom_unfused", "H": 120, "W": 160, "points": len(pc),
           "wall_s": wall, "launches": launches, "geom_terms_expected": k3_expected,
           "score_views_pre_expected": pre_expected,
           "score_hypotheses_calls": calls,
           "mask_agreement_with_default": mask_agree,
           "depth_agreement_with_default": depth_agree,
           "bit_identical_with_default": identical, "card": card}
    emit(rec)
    _check_scoring(launches, calls)
    if (launches["geom_terms"] != k3_expected or launches["geom_term"] or k2
            or launches["score_views_pre_exact"] != pre_expected):
        raise RuntimeError(f"unfused launches {launches}: expected {k3_expected} "
                           f"K3-mv, {pre_expected} precomputed-mode, no per-view "
                           "K3 and no K2-mv")
    if min(mask_agree) < 0.999 or min(depth_agree) < 0.999:
        raise RuntimeError("unfused and default depth maps disagree")


def _noisy_grid(grid, seed):
    """(ground-truth mesh, its vertices with z-noise N(0, 0.05) from
    default_rng(seed)); bench.py's refine leg perturbs the same way."""
    import numpy as np

    from openmvs_tpu_torch.synthetic import height_field_mesh

    gt = height_field_mesh(grid)
    v = gt.vertices.copy()
    v[:, 2] += np.random.default_rng(seed).normal(0, 0.05, len(v)).astype(np.float32)
    return gt, v


def _height_error(vertices):
    """Mean |z - height(x, y)| over the vertices."""
    import numpy as np

    from openmvs_tpu_torch.synthetic import height

    v = np.asarray(vertices, np.float64)
    return float(np.abs(v[:, 2] - height(v[:, 0], v[:, 1])).mean())


def _mesh_height_quality(vertices):
    """(mean |z - height(x, y)|, share of those errors within HEIGHT_TOL,
    vertex count) over the vertices whose (x, y) falls in the height
    field's domain [-3, 3]^2. A reconstructed mesh also carries faces on
    the hull beyond the domain, where the truth has no height: the face
    counts limit those. Either package's vertices."""
    import numpy as np

    from openmvs_tpu_torch.synthetic import height

    v = np.asarray(vertices, np.float64)
    v = v[(np.abs(v[:, 0]) <= 3.0) & (np.abs(v[:, 1]) <= 3.0)]
    err = np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))
    return float(err.mean()), float((err <= HEIGHT_TOL).mean()), len(v)


class _FullScale:
    """The full-scale inputs of one refinement iteration for vertices
    ``v0`` (subdivided as refine_mesh's last scale would), on the host;
    ``on(dev)`` uploads them: (PairData, MeshTensors, the four float32
    scalars, PairStatic)."""

    def __init__(self, scene, v0, faces):
        import numpy as np

        from openmvs_tpu_torch import refine
        from openmvs_tpu_torch.config import RefineOptions
        from openmvs_tpu_torch.convert import mesh_from_numpy

        opts = RefineOptions()
        self.pairs = refine.select_pairs(scene, opts)
        self.grays, self.cams = refine.scaled_views(scene, 1.0)
        t0 = time.perf_counter()
        mesh = refine.subdivide_to_area(mesh_from_numpy(v0, faces), scene,
                                        float(opts.max_face_area))
        t1 = time.perf_counter()
        self.v, self.faces = mesh.vertices, mesh.faces
        self.adj, self.deg = refine._vertex_adjacency(self.faces, len(self.v))
        # host seconds of the two Python loops over faces, once per scale
        self.host_s = {"subdivide": t1 - t0, "adjacency": time.perf_counter() - t1}
        self.bnd = refine._vertex_boundary(self.faces, len(self.v))
        self.statics = refine.build_statics(self.pairs, self.grays, self.cams)
        e = self.v[self.faces[:, 0]] - self.v[self.faces[:, 1]]
        self.scalars = (refine.decode_step(opts.gradient_step),
                        float(np.median(np.linalg.norm(e, axis=1))),
                        opts.regularity_weight, opts.rigidity_elasticity_ratio)

    def rasters(self, v):
        from openmvs_tpu_torch import refine

        return refine.build_rasters(self.pairs, self.grays, self.cams, self.faces, v)

    def on(self, dev):
        import torch

        from openmvs_tpu_torch import refine

        mt = refine.mesh_tensors(self.v, self.faces, self.adj, self.deg, self.bnd, dev)
        statics = refine.to_device(self.statics, dev)
        pds = refine._assemble_pair_data(statics, refine.to_device(self.rasters(self.v), dev),
                                         mt.faces)
        scal = [torch.tensor(x, dtype=torch.float32, device=dev) for x in self.scalars]
        return pds, mt, scal, statics


def _profile_refresh(fs, dev):
    """One full-scale refresh block as _refine_at_scale runs it (download,
    rasterize, upload, 8 iterations, the energy read), eager
    (_device_iter) and graphed (refine.IterProgram, captured by an earlier
    block), each once unprofiled and once under torch.profiler: per
    iteration the kernels run on the device, the host's kernel launches and
    graph replays; the device-busy share of the unprofiled wall, the top 10
    device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from openmvs_tpu_torch import refine
    from openmvs_tpu_torch.ops import graphs

    _, mt, (step0, med, reg_w, ratio), statics = fs.on(dev)
    prog = refine.IterProgram(graphs.Runner(dev), mt, statics, step0, med, reg_w,
                              refine.RERASTER)

    def block(graphed):
        t0 = time.perf_counter()
        if graphed:
            r = refine.to_device(fs.rasters(prog.v.cpu().numpy()), dev)
            prog.refresh(r, fs.scalars[3], 0)
            for _ in range(refine.RERASTER):
                prog.step()
            e = prog.e
        else:
            v = mt.verts
            r = refine.to_device(fs.rasters(v.cpu().numpy()), dev)
            p = refine._assemble_pair_data(statics, r, mt.faces)
            for k in range(refine.RERASTER):
                v, e = refine._device_iter(v, k, p, mt.adj, mt.deg, mt.faces, step0,
                                           med, reg_w, mt.boundary, ratio)
        float(e)
        return time.perf_counter() - t0

    out = {}
    for name in ("eager", "graphed"):
        block(name == "graphed")
        wall = block(name == "graphed")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_profiled = block(name == "graphed")
        d = _device_summary(prof, 10)
        api = _host_calls(prof)
        n = refine.RERASTER
        out[name] = {"block_wall_s": wall, "block_wall_profiled_s": wall_profiled,
                     "iterations": n, "kernels_run_per_iteration": d["launches"] / n,
                     "host_kernel_launches_per_iteration":
                         sum(api.get(k, 0) for k in LAUNCH_APIS) / n,
                     "graph_replays_per_iteration": api.get("cudaGraphLaunch", 0) / n,
                     "copies": d["copies"], "device_busy_s": d["busy_s"],
                     "device_busy_share": min(d["busy_s"] / wall, 1.0),
                     "top10_kernels": d["top"]}
    return out


def _graphed_iter_ms(fs, dev):
    """CUDA-event ms of one full-scale iteration replayed from its CUDA
    graph (refine.IterProgram; its first, eager step and the capture
    before the timed replays)."""
    from openmvs_tpu_torch import refine
    from openmvs_tpu_torch.ops import graphs

    _, mt, (step0, med, reg_w, _), statics = fs.on(dev)
    prog = refine.IterProgram(graphs.Runner(dev), mt, statics, step0, med, reg_w, 16)
    prog.refresh(refine.to_device(fs.rasters(fs.v), dev), fs.scalars[3], 0)
    prog.step()
    return cuda_ms(prog.step, 5)


def _segment_sum_rows(card, fs, dev):
    """The segment sums of one full-scale _energy_grad on the card (the
    pixels into faces, the faces' support into vertices, the faces into
    vertices, the face normals into vertices): each through the kernel
    against its plain version on the card and against _segment_sum's CPU
    form (the definition: each segment folded from 0 in row order), bit
    for bit; CUDA-event ms of the kernel (graph replay, and eager), of the
    kernel with its sort and offsets, of the plain version and of one
    torch.segment_reduce over the gathered rows (the library column), and
    the bytes bound: the rows the kernel sums (those of segments 0 to
    n - 1; rows at index n, the pixels with no face, are left out and not
    read), their order entries, the offsets and the output, each moved
    once. Returns the records and their sum (one iteration)."""
    import torch

    from openmvs_tpu_torch import refine
    from openmvs_tpu_torch.ops import segment

    pds, mt, (step0, med, reg_w, ratio), _ = fs.on(dev)
    calls = []
    seg = refine._segment_sum

    def recorded(index, src, n):
        calls.append((index, src.contiguous(), n))
        return seg(index, src, n)

    refine._segment_sum = recorded
    try:
        refine._energy_grad(mt.verts, pds, mt.adj, mt.deg, mt.faces, step0, med, reg_w,
                            mt.boundary, ratio)
    finally:
        refine._segment_sum = seg

    def bits(t):
        return t.cpu().contiguous().view(torch.int32)

    recs = []
    for index, src, n in calls:
        order, offsets = segment.segments(index, n)
        got = segment.segment_sum(order, offsets, src)
        plain = segment.segment_sum_plain(order, offsets, src)
        want = seg(index.cpu(), src.cpu(), n)
        gathered = src.index_select(0, order)
        lengths = offsets[1:] - offsets[:-1]
        R, K = src.shape[0], src[0].numel()
        summed = int(offsets[n] - offsets[0])
        nbytes = summed * (K * 4 + 8) + (n + 1) * 8 + n * K * 4
        rec = {"phase": "refine", "kernel": "segment_sum", "rows": R,
               "left_out_rows": R - summed, "segments": n,
               "columns": K, "longest_segment": int(lengths.max()),
               "empty_segments": int((lengths == 0).sum()),
               "equal_cpu_form": bool(torch.equal(bits(got), bits(want))),
               "equal_card_plain": bool(torch.equal(bits(got), bits(plain))),
               "max_abs_err": float((got.cpu() - want).abs().max()),
               "ms": cuda_ms(lambda: segment.segment_sum(order, offsets, src), 20,
                             graph=True),
               "eager_ms": cuda_ms(lambda: segment.segment_sum(order, offsets, src), 20),
               "with_order_ms": cuda_ms(lambda: segment.segment_sum(
                   *segment.segments(index, n), src), 10, graph=True),
               "plain_ms": cuda_ms(lambda: segment.segment_sum_plain(order, offsets, src),
                                   5),
               "library_ms": cuda_ms(lambda: torch.segment_reduce(
                   gathered, "sum", offsets=offsets, axis=0, unsafe=True), 5),
               "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
               "bound_by": "bytes", "card": card}
        emit(rec)
        recs.append(rec)
    if not all(r["equal_cpu_form"] and r["equal_card_plain"] for r in recs):
        raise RuntimeError("segment_sum differs from its plain version or from "
                           "_segment_sum's CPU form")
    total = {k: sum(r[k] for r in recs)
             for k in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms")}
    total.update(bound_by="bytes", max_abs_err=max(r["max_abs_err"] for r in recs),
                 calls=len(recs), left_out_rows=sum(r["left_out_rows"] for r in recs))
    return recs, total


def _refine_card_vs_cpu():
    """The tests' small case (3 views at 160x120, the 22-grid with z-noise
    from default_rng(7), RefineOptions(scales=2, iters=8,
    max_face_area=64)) through refine_mesh on the card and on the CPU:
    (rms distance difference, largest per-vertex difference, seconds)."""
    import numpy as np
    from scipy.spatial import cKDTree

    from openmvs_tpu_torch import refine
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.synthetic import build_gt_scene

    out, secs = {}, {}
    gt, v0 = _noisy_grid(22, 7)
    for dev in ("cuda", "cpu"):
        scene, _, _ = build_gt_scene(n_views=3, W=160, H=120)
        t0 = time.perf_counter()
        out[dev] = refine.refine_mesh(
            scene, mesh_from_numpy(v0, gt.faces),
            RefineOptions(scales=2, iters=8, max_face_area=64), device=dev).vertices
        secs[dev] = time.perf_counter() - t0
    tree = cKDTree(gt.vertices)

    def rms(v):
        d, _ = tree.query(v, k=1)
        return float(np.sqrt((d ** 2).mean()))
    return (abs(rms(out["cuda"]) - rms(out["cpu"])),
            float(np.abs(out["cuda"] - out["cpu"]).max()), secs)


def phase_refine(card, scene):
    """Mesh refinement on the card: the full-size workload through
    refine_mesh (its iterations replayed from CUDA graphs, with the
    segment_sum launches counted from 0 over the call) and again with
    _eager=True (vertices equal to the bit), one full-scale iteration timed
    both ways, one refresh block profiled both ways, the segment sums of
    one iteration against their plain version, and the card against the
    CPU. Returns (the kernels line's segment_sum row, its launches)."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import refine
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.ops import pm_kernel, segment

    from openmvs_tpu_torch import native

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    native.build()   # the host rasterizer (g++), outside the timed call
    build_s = time.perf_counter() - t0
    gt, v0 = _noisy_grid(150, 11)
    err0 = _height_error(v0)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pm_kernel.reset_launches()
    t0 = time.perf_counter()
    out = refine.refine_mesh(scene, mesh_from_numpy(v0, gt.faces), RefineOptions(),
                             device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pm_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    err1 = _height_error(out.vertices)
    stats_e = {}
    t0 = time.perf_counter()
    out_e = refine.refine_mesh(scene, mesh_from_numpy(v0, gt.faces), RefineOptions(),
                               device="cuda", stats=stats_e, _eager=True)
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    same = bool(np.array_equal(np.asarray(out.faces), np.asarray(out_e.faces))
                and np.array_equal(np.asarray(out.vertices, np.float32).view(np.int32),
                                   np.asarray(out_e.vertices, np.float32).view(np.int32)))

    fs = _FullScale(scene, v0, gt.faces)
    pds, mt, (step0, med, reg_w, ratio), _ = fs.on(dev)
    iter_ms = cuda_ms(lambda: refine._device_iter(
        mt.verts, 0, pds, mt.adj, mt.deg, mt.faces, step0, med, reg_w,
        mt.boundary, ratio), 5)
    graphed_iter_ms = _graphed_iter_ms(fs, dev)
    prof = _profile_refresh(fs, dev)
    seg_recs, seg_row = _segment_sum_rows(card, fs, dev)
    e_card, g_card = refine._energy_grad(mt.verts, pds, mt.adj, mt.deg, mt.faces,
                                         step0, med, reg_w, mt.boundary, ratio)
    pds_c, mt_c, sc_c, _ = fs.on(torch.device("cpu"))
    e_cpu, g_cpu = refine._energy_grad(mt_c.verts, pds_c, mt_c.adj, mt_c.deg, mt_c.faces,
                                       *sc_c[:3], mt_c.boundary, sc_c[3])
    g_card, g_cpu = g_card.cpu().numpy(), g_cpu.numpy()
    g_atol = 1e-6 * float(np.abs(g_cpu).max())
    g_fail = int((np.abs(g_card - g_cpu) > 1e-4 * np.abs(g_cpu) + g_atol).sum())
    rms_diff, worst, small_s = _refine_card_vs_cpu()
    rec = {"phase": "refine", "views": len(scene.images), "H": 480, "W": 640,
           "faces": len(gt.faces), "vertices": len(v0), "options": "RefineOptions()",
           "wall_s": wall, "scales": stats["scales"], "pairs": stats["pairs"],
           "iterations": sum(s["iters"] for s in stats["scales"]),
           "refreshes": sum(s["refreshes"] for s in stats["scales"]),
           "host_s": stats["host_s"], "rasterizer_build_s": build_s,
           "max_memory_allocated_bytes": peak,
           "height_error_before": err0, "height_error_after": err1,
           "jax_height_error_after": JAX_REFINE_HEIGHT_ERROR,
           "full_scale_faces": len(fs.faces), "full_scale_pairs": len(fs.pairs),
           "full_scale_host_s": fs.host_s, "graphs": stats["graphs"],
           "segment_sum_launches": launches["segment_sum"],
           "eager_wall_s": wall_e, "eager_scales": stats_e["scales"],
           "vertices_equal_eager": same,
           "device_iter_ms": iter_ms, "graphed_device_iter_ms": graphed_iter_ms,
           "segment_sum_iteration": seg_row, "profile_refresh_block": prof,
           "energy_grad_card_vs_cpu": {
               "energy": [float(e_card), float(e_cpu)],
               "max_abs_diff": float(np.abs(g_card - g_cpu).max()),
               "max_abs": float(np.abs(g_cpu).max()),
               "bit_equal_share": float((g_card == g_cpu).mean()),
               "outside_rtol_1e-4_atol_1e-6_max": g_fail},
           "small_case_card_vs_cpu": {"rms_diff": rms_diff, "max_vertex_diff": worst,
                                      "seconds": small_s},
           "card": card}
    emit(rec)
    if not np.isfinite(np.asarray(out.vertices)).all():
        raise RuntimeError("refine produced non-finite vertices")
    if err1 > 0.85 * err0:
        raise RuntimeError(f"refine recovered too little: height error {err0} -> {err1}")
    if err1 > 1.05 * JAX_REFINE_HEIGHT_ERROR:
        raise RuntimeError(f"height error {err1} above 1.05x the JAX package's "
                           f"{JAX_REFINE_HEIGHT_ERROR}")
    if g_fail:
        raise RuntimeError(f"_energy_grad: {g_fail} elements differ between card and CPU "
                           "beyond rtol 1e-4, atol 1e-6 max|g|")
    if rms_diff >= 1e-4 or worst >= 5e-3:
        raise RuntimeError(f"refine_mesh card vs CPU: rms difference {rms_diff}, "
                           f"largest vertex difference {worst}")
    if not same:
        raise RuntimeError("graphed refine_mesh differs from the eager run")
    g = stats["graphs"]
    if not (g["captures"] and g["replays"] and launches["segment_sum"]):
        raise RuntimeError(f"refine_mesh: {g} and {launches} (no graph or no kernel)")
    if prof["graphed"]["graph_replays_per_iteration"] != 1:
        raise RuntimeError(f"graphed refresh block: {prof['graphed']}")
    return seg_row, launches


def _color_fidelity(mesh, labels, images):
    """Per labelled face, the mean |atlas color - source color| (over RGB)
    at the face's centroid: the atlas texel under the mean of its
    texcoords, on its page, against the pixel of its labelled view under
    the projected centroid (tests/test_texture.py:82-103, there for every
    7th face and view 0). Returns the median over the faces and the share
    of faces within FIDELITY_BOUND. Duck-typed, so it reads either
    package's textured mesh and images."""
    import numpy as np

    from openmvs_tpu_torch.texture import _project

    nf = len(mesh.faces)
    pages = mesh.textures if mesh.textures is not None else [mesh.texture]
    page = (np.asarray(mesh.face_page) if mesh.face_page is not None
            else np.zeros(nf, np.int64))
    fi = np.nonzero(np.asarray(labels) >= 0)[0]
    tc = np.asarray(mesh.face_tex_coords)[fi].mean(axis=1)
    cen = np.asarray(mesh.vertices)[np.asarray(mesh.faces)[fi]].mean(axis=1)
    atlas_col = np.zeros((len(fi), 3))
    img_col = np.zeros((len(fi), 3))
    for pg, tex in enumerate(pages):
        sel = page[fi] == pg
        th, tw = tex.shape[:2]
        tx = np.clip((tc[sel, 0] * tw).astype(np.int64), 0, tw - 1)
        ty = np.clip(((1 - tc[sel, 1]) * th).astype(np.int64), 0, th - 1)
        atlas_col[sel] = tex[ty, tx]
    lab = np.asarray(labels)[fi]
    for v in np.unique(lab):
        sel = lab == v
        img = images[int(v)]
        h, w = img.color.shape[:2]
        pr = _project(img.working_camera(), cen[sel])
        pu = np.clip(pr[:, 0].astype(np.int64), 0, w - 1)
        pv = np.clip(pr[:, 1].astype(np.int64), 0, h - 1)
        img_col[sel] = img.color[pv, pu]
    err = np.abs(atlas_col - img_col).mean(axis=1)
    return float(np.median(err)), float((err <= FIDELITY_BOUND).mean())


def _file_color_fidelity(mesh, images):
    """Color fidelity of a textured mesh read back from its files, where the
    labels are not at hand: per face whose centroid lies in the height
    field's domain, the mean |atlas color - source color| (over RGB) at the
    centroid against each view whose image holds the projected centroid,
    the least over those views. Returns the median over the faces and the
    share within FIDELITY_BOUND. Duck-typed, as _color_fidelity."""
    import numpy as np

    from openmvs_tpu_torch.texture import _project

    nf = len(mesh.faces)
    pages = mesh.textures if mesh.textures is not None else [mesh.texture]
    page = (np.asarray(mesh.face_page) if mesh.face_page is not None
            else np.zeros(nf, np.int64))
    cen = np.asarray(mesh.vertices, np.float64)[np.asarray(mesh.faces)].mean(axis=1)
    fi = np.nonzero((np.abs(cen[:, 0]) <= 3.0) & (np.abs(cen[:, 1]) <= 3.0))[0]
    tc = np.asarray(mesh.face_tex_coords)[fi].mean(axis=1)
    atlas_col = np.zeros((len(fi), 3))
    for pg, tex in enumerate(pages):
        sel = page[fi] == pg
        th, tw = tex.shape[:2]
        tx = np.clip((tc[sel, 0] * tw).astype(np.int64), 0, tw - 1)
        ty = np.clip(((1 - tc[sel, 1]) * th).astype(np.int64), 0, th - 1)
        atlas_col[sel] = tex[ty, tx]
    err = np.full(len(fi), np.inf)
    for img in images:
        h, w = img.color.shape[:2]
        pr = _project(img.working_camera(), cen[fi])
        ok = (pr[:, 2] > 0) & (pr[:, 0] >= 0) & (pr[:, 0] < w) & (pr[:, 1] >= 0) & (pr[:, 1] < h)
        pu = np.clip(pr[:, 0].astype(np.int64), 0, w - 1)
        pv = np.clip(pr[:, 1].astype(np.int64), 0, h - 1)
        e = np.abs(atlas_col - img.color[pv, pu]).mean(axis=1)
        err = np.where(ok, np.minimum(err, e), err)
    err = err[np.isfinite(err)]
    return float(np.median(err)), float((err <= FIDELITY_BOUND).mean())


def _face_pixels(scene, mesh):
    """How large the mesh's faces are in the views: the pixel centres the
    rasterizer gives each (face, view) (what compute_face_qualities sums the
    gradient over), and the projected area in pixels of each (face, view)
    whose corners all lie in front of the camera and inside the image,
    occluded or not."""
    import numpy as np

    from openmvs_tpu_torch import native
    from openmvs_tpu_torch.texture import _project

    nf = len(mesh.faces)
    counts = np.zeros((nf, len(scene.images)), np.int64)
    areas = []
    for vi, img in enumerate(scene.images):
        H, W = img.gray.shape
        proj = _project(img.working_camera(), mesh.vertices.astype(np.float64))
        fid, _, _ = native.rasterize(proj, mesh.faces, H, W, want_bary=False)
        counts[:, vi] = np.bincount(fid[fid >= 0].astype(np.int64), minlength=nf)
        t = proj[mesh.faces]
        inside = ((t[..., 2] > 0) & (t[..., 0] >= -0.5) & (t[..., 0] <= W - 0.5)
                  & (t[..., 1] >= -0.5) & (t[..., 1] <= H - 0.5)).all(axis=1)
        d1, d2 = t[inside, 1, :2] - t[inside, 0, :2], t[inside, 2, :2] - t[inside, 0, :2]
        areas.append(0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]))
    area = np.concatenate(areas)
    seen = counts > 0
    best = counts.max(axis=1)
    return {"projected_area_px": {q: float(np.percentile(area, int(q[1:])))
                                  for q in ("p10", "p50", "p90")},
            "pixels_per_seen_face_view": {"mean": float(counts[seen].mean()),
                                          "p50": float(np.median(counts[seen]))},
            "pixels_in_best_view_p50": float(np.median(best)),
            "faces_with_at_most_1_pixel_in_best_view": float((best <= 1).mean()),
            "faces_without_a_pixel": float((best == 0).mean())}


def _profile_lbp(quality, adj, lam, iters):
    """label_faces_lbp on the card once unprofiled and once under
    torch.profiler (after a warm-up call): kernel launches in all and per
    iteration, copies, device-busy share of the unprofiled wall, the top 5
    device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from openmvs_tpu_torch import texture

    def call():
        t0 = time.perf_counter()
        texture.label_faces_lbp(quality, adj, lam, iters=iters, device="cuda")
        return time.perf_counter() - t0

    call()
    wall = call()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_profiled = call()
    dev = _device_summary(prof, 5)
    return {"wall_s": wall, "wall_profiled_s": wall_profiled,
            "kernel_launches": dev["launches"],
            "kernel_launches_per_iteration": dev["launches"] / iters,
            "copies": dev["copies"], "device_busy_s": dev["busy_s"],
            "device_busy_share": min(dev["busy_s"] / wall, 1.0),
            "top5_kernels": dev["top"]}


def _texture_run(scene, mesh, device):
    """texture_mesh(scene, mesh, TextureOptions()) on ``device``: the
    textured mesh, its stats, the call's seconds and peak device memory."""
    import torch

    from openmvs_tpu_torch import texture
    from openmvs_tpu_torch.config import TextureOptions

    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = texture.texture_mesh(scene, mesh, TextureOptions(), device=device, stats=stats)
    wall = time.perf_counter() - t0
    return out, stats, wall, torch.cuda.max_memory_allocated()


def _texture_summary(out, stats, wall, peak, scene, mesh):
    """The record of one _texture_run; fails on texcoords outside [0, 1] or
    atlas pages that are not (h, w, 3) uint8."""
    import numpy as np

    stages = stats["stages_s"]
    pages = out.textures if out.textures is not None else [out.texture]
    fidelity, within = _color_fidelity(out, stats["labels"], scene.images)
    tc = np.asarray(out.face_tex_coords)
    if tc.shape != (len(mesh.faces), 3, 2) or not ((tc >= 0) & (tc <= 1)).all():
        raise RuntimeError(f"texcoords of shape {tc.shape} or outside [0, 1]")
    if any(p.dtype != np.uint8 or p.ndim != 3 or p.shape[2] != 3 for p in pages):
        raise RuntimeError("atlas pages are not (h, w, 3) uint8")
    return {"faces": len(mesh.faces), "vertices": len(mesh.vertices),
            "wall_s": wall, "stages_s": stages,
            "generate_patches_pack_copy_s": stages["generate"] - sum(
                stages.get(k, 0.0) for k in ("global_leveling", "local_leveling", "sharpen")),
            "unseen_share": stats["unseen_share"], "restricted_mrf": stats["restricted_mrf"],
            "patches": stats["patches"], "pages": stats["pages"],
            "atlas_wh": list(stats["atlas_wh"]), "max_memory_allocated_bytes": peak,
            "face_pixels": _face_pixels(scene, mesh),
            "color_fidelity": fidelity, f"faces_within_{FIDELITY_BOUND}": within}


def phase_texture(card, scene):
    """Texturing on the card: texture_mesh(scene, mesh, TextureOptions())
    for the 5-view 640x480 scene with colors and the height field's 320-grid
    (203,522 faces, above the 200k at which the JAX package labels on its
    device), held to the same call on the CPU; then label_faces_lbp alone on
    the same qualities, timed, profiled and held to its CPU labels; then
    the 150-grid (44,402 faces, several pixels each), for the patch count
    and the stages at faces larger than a pixel."""
    import inspect

    import numpy as np

    from openmvs_tpu_torch import native, texture
    from openmvs_tpu_torch.config import TextureOptions
    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.synthetic import height_field_mesh
    from openmvs_tpu_torch.utils import device as device_mod

    iters = inspect.signature(texture.label_faces_lbp).parameters["iters"].default
    native.build()
    mesh = height_field_mesh(320)
    out, stats, wall, peak = _texture_run(scene, mesh, "cuda")
    main = _texture_summary(out, stats, wall, peak, scene, mesh)
    # the same call with the labeling on the CPU: all else is host code
    cout, cstats, cwall, _ = _texture_run(scene, mesh, "cpu")
    pages = out.textures if out.textures is not None else [out.texture]
    cpages = cout.textures if cout.textures is not None else [cout.texture]
    same_shapes = [p.shape for p in pages] == [p.shape for p in cpages]
    diffs = [np.abs(p.astype(np.int16) - q.astype(np.int16))
             for p, q in zip(pages, cpages)] if same_shapes else []
    vs_cpu = {"wall_s": cwall, "labels_equal": bool(np.array_equal(stats["labels"],
                                                                   cstats["labels"])),
              "texcoords_equal": bool(np.array_equal(out.face_tex_coords,
                                                     cout.face_tex_coords)),
              "atlas_shapes_equal": same_shapes,
              "texel_equal_share": float(np.mean([(d == 0).mean() for d in diffs]))
              if diffs else None,
              "texel_max_abs_diff": int(max(d.max() for d in diffs)) if diffs else None}

    # the labeling alone, on the qualities texture_mesh computed
    opts = TextureOptions()
    max_dim = imio.compute_max_resolution(
        max(im.width for im in scene.images), max(im.height for im in scene.images),
        opts.resolution_level, opts.min_resolution, 1 << 30)
    q, fc = texture.compute_face_qualities(scene, mesh, max_dim)
    q = texture.remove_outlier_views(q, fc, opts.outlier_threshold)
    adj = texture._face_adjacency(mesh.faces)
    lam = opts.ratio_data_smoothness * 10
    t0 = time.perf_counter()
    lab_cpu = texture.label_faces_lbp(q, adj, lam, iters=iters, device="cpu")
    cpu_s = time.perf_counter() - t0
    lab_card = texture.label_faces_lbp(q, adj, lam, iters=iters, device="cuda")
    lbp_ms = cuda_ms(lambda: texture.label_faces_lbp(q, adj, lam, iters=iters,
                                                     device="cuda"), 5)
    # the message schedule alone, its inputs already built on the host
    qmax = q.max(axis=1, keepdims=True)
    data = np.where(q > 0, 1.0 - q / np.maximum(qmax, 1e-12), 4.0).astype(np.float32)
    lam_k = np.full((len(q), 3), np.float32(lam), np.float32)
    _, rev, valid = texture._rev_slots(adj)
    dev = device_mod.resolve("cuda")
    schedule_ms = cuda_ms(lambda: texture._lbp_schedule(data, adj, lam_k, rev, valid,
                                                        iters, [dev]), 5)
    prof = _profile_lbp(q, adj, lam, iters)

    small = height_field_mesh(150)
    grid150 = _texture_summary(*_texture_run(scene, small, "cuda"), scene, small)
    H, W = scene.images[0].gray.shape
    rec = {"phase": "texture", "views": len(scene.images), "H": H, "W": W,
           "options": "TextureOptions()", **main,
           "jax_color_fidelity": JAX_TEXTURE_FIDELITY,
           f"jax_faces_within_{FIDELITY_BOUND}": JAX_TEXTURE_WITHIN,
           "cpu_texture_mesh": vs_cpu, "lbp_iters": iters,
           "lbp_ms": lbp_ms, "lbp_schedule_ms": schedule_ms, "lbp_cpu_s": cpu_s,
           "lbp_profile": prof,
           "labels_card_equal_cpu": bool(np.array_equal(lab_card, lab_cpu)),
           "labels_card_equal_texture_mesh": bool(np.array_equal(lab_card, stats["labels"])),
           "grid150": grid150, "card": card}
    emit(rec)
    if not rec["labels_card_equal_cpu"]:
        raise RuntimeError(f"LBP labels differ between card and CPU on "
                           f"{int((lab_card != lab_cpu).sum())} faces")
    if not rec["labels_card_equal_texture_mesh"]:
        raise RuntimeError("label_faces_lbp and texture_mesh labelled differently")
    if not (vs_cpu["labels_equal"] and vs_cpu["texcoords_equal"] and same_shapes
            and vs_cpu["texel_equal_share"] >= 0.999 and vs_cpu["texel_max_abs_diff"] <= 1):
        raise RuntimeError(f"texture_mesh on the card differs from the CPU: {vs_cpu}")
    if not main["color_fidelity"] <= 1.02 * JAX_TEXTURE_FIDELITY:
        raise RuntimeError(f"color fidelity {main['color_fidelity']} above 1.02x the "
                           f"JAX package's {JAX_TEXTURE_FIDELITY}")
    within = main[f"faces_within_{FIDELITY_BOUND}"]
    if not within >= 0.98 * JAX_TEXTURE_WITHIN:
        raise RuntimeError(f"{within} of faces within {FIDELITY_BOUND} of their source "
                           f"color, below 0.98x the JAX package's {JAX_TEXTURE_WITHIN}")


def _sgm_dense(scene, opts, folder, fusion_mode=0):
    """dense_reconstruction(scene, opts, save_dmaps_to=folder) on the card
    with the launch counts set to 0 just before and read just after, and
    every match_pair_tsgm call recorded: (cloud, wall s, stage s, per-pair
    records with their levels and the graph captures the pair made,
    kernel launches, the call's graphs as _graph_summary gives them)."""
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.ops import pm_kernel, rectify_kernel, sgm

    pairs = []
    match = sgm.match_pair_tsgm

    def captures(runners):
        return sum(r.captures for r in runners.all()) if runners is not None else 0

    def recorded(*a, **kw):
        levels = []
        before = captures(kw.get("runners"))
        t0 = time.perf_counter()
        out = match(*a, stats=levels, **kw)
        pairs.append({"seconds": time.perf_counter() - t0, "levels": levels,
                      "captures": captures(kw.get("runners")) - before})
        return out

    stage_log = _StageLog()
    logger = logging.getLogger("omvs_torch.densify")
    logger.addHandler(stage_log)
    sgm.match_pair_tsgm = recorded
    try:
        with _graph_runners() as made:
            pm_kernel.reset_launches()
            rect0 = rectify_kernel.LAUNCHES["rectify_warp"]
            t0 = time.perf_counter()
            pc = densify.dense_reconstruction(scene, opts, save_dmaps_to=folder,
                                              fusion_mode=fusion_mode, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(pm_kernel.LAUNCHES,
                            rectify_warp=rectify_kernel.LAUNCHES["rectify_warp"] - rect0)
            graphs_ = _graph_summary(made)
    finally:
        sgm.match_pair_tsgm = match
        logger.removeHandler(stage_log)
    return pc, wall, stage_log.stages, pairs, launches, graphs_


def _check_captured_classes(pairs):
    """Pairs in call order: a level's shape class (h, w, num_d, last level)
    is captured at its second run, so a pair whose every class ran twice
    before it must capture nothing. Returns how many pairs were such."""
    runs = {}
    held = 0
    for i, p in enumerate(pairs):
        classes = [(lv["hw"][0], lv["hw"][1], lv["num_d"], k == len(p["levels"]) - 1)
                   for k, lv in enumerate(p["levels"])]
        if classes and all(runs.get(c, 0) >= 2 for c in classes):
            held += 1
            if p["captures"]:
                raise RuntimeError(f"SGM pair {i}: {p['captures']} captures, though its "
                                   f"classes {classes} were captured before")
        for c in classes:
            runs[c] = runs.get(c, 0) + 1
    return held


def _sgm_pair(scene, view):
    """(rectA, rectB, d_lo, d_hi) of view ``view`` and its best neighbour,
    rectified and seeded as estimate_depth_map_sgm does."""
    import numpy as np

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import sgm

    img = scene.images[view]
    nb = next(im for im in scene.images if im.meta.id == img.meta.view_scores[0].id)
    camA, camB = img.working_camera(), nb.working_camera()
    rectA, rectB, info = sgm.rectify_pair(camA, camB, img.gray, nb.gray)
    pts = np.asarray([scene.pointcloud.points[i]
                      for i, v in enumerate(scene.pointcloud.views) if img.meta.id in v],
                     np.float64).reshape(-1, 3)
    d_lo, d_hi = densify._sgm_pair_range(pts, info, camA, camB,
                                         DenseOptions(estimator="sgm"))
    return rectA, rectB, d_lo, d_hi


def _profile_sgm_pair(rectA, rectB, d_lo, d_hi, runners=None):
    """match_pair_tsgm of one pair on the card, once unprofiled and once
    under torch.profiler: the pair's wall, device-busy share, kernels run
    on the device, the host's kernel launches, graph replays and copies
    (its CUDA calls in the trace), and the captures of the profiled call.
    With ``runners`` (whose programs the caller has captured) the levels
    replay CUDA graphs; without, they launch op by op and each aggregate8
    call is marked: per call the kernel launches (CUDA launch calls inside
    its range) and host ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from openmvs_tpu_torch.ops import sgm

    def call():
        t0 = time.perf_counter()
        sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cuda", runners=runners)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    agg = sgm.aggregate8

    def marked(*a, **kw):
        with record_function("sgm.aggregate8"):
            out = agg(*a, **kw)
            torch.cuda.synchronize()
            return out

    def n_captures():
        return sum(r.captures for r in runners.all()) if runners is not None else 0

    call()
    wall = call()
    before = n_captures()
    if runners is None:
        sgm.aggregate8 = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_profiled = call()
    finally:
        sgm.aggregate8 = agg
    dev = _device_summary(prof, 10, skip={"sgm.aggregate8"})
    api = _host_calls(prof)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "sgm.aggregate8"]
    launch_t = [e.time_range.start for e in events
                if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    per_call = [sum(a <= t <= b for t in launch_t) for a, b in ranges]
    return {"mode": "eager" if runners is None else "graphed",
            "wall_s": wall, "wall_profiled_s": wall_profiled,
            "kernel_launches": dev["launches"], "copies": dev["copies"],
            "host_kernel_launches": sum(api.get(k, 0) for k in LAUNCH_APIS),
            "graph_replays": api.get("cudaGraphLaunch", 0),
            "host_copies": api.get("cudaMemcpyAsync", 0),
            "captures": n_captures() - before,
            "device_busy_s": dev["busy_s"],
            "device_busy_share": min(dev["busy_s"] / wall, 1.0),
            "aggregate8_calls": len(ranges),
            "aggregate8_launches": per_call,
            "aggregate8_host_ms": [(b - a) / 1e3 for a, b in ranges],
            "top10_kernels": dev["top"]}


def _sgm_scan_rows(card, rectA, rectB, d_lo, d_hi):
    """sgm_scan at a full-width pair's shapes: the DP batches of the last
    (finest) aggregate8 call of match_pair_tsgm on the card (horizontal,
    vertical, diagonal) and of aggregate over that level's left volume as
    floats (horizontal, vertical), each through the kernel against
    _scan_passes_plain on the card, bit for bit (int32 views: signed zeros
    count); CUDA-event ms of the kernel (graph replay, and eager) and of
    the plain loop, and the bound. Returns the records and the kernels
    line's row: aggregate8's three batches summed (one call)."""
    import torch

    from openmvs_tpu_torch.ops import sgm

    last = []
    agg8 = sgm.aggregate8

    def recorded(*a, **kw):
        last[:] = [(a, kw)]
        return agg8(*a, **kw)

    sgm.aggregate8 = recorded
    try:
        sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cuda")
    finally:
        sgm.aggregate8 = agg8
    (vol, imgs, *rest), kw = last[0]
    batches = []
    scan = sgm._scan_passes

    def kept(xs, p2s, p1, shift, diag):
        batches.append((xs.contiguous(), p2s.contiguous(), p1, shift, diag))
        return scan(xs, p2s, p1, shift, diag)

    sgm._scan_passes = kept
    try:
        agg8(vol, imgs, *rest, **kw)
        sgm.aggregate(vol[0].to(torch.float32) / 255.0, imgs[0], p1=0.1, p2=0.8, alpha=2.0)
    finally:
        sgm._scan_passes = scan
    names = ("aggregate8_horizontal", "aggregate8_vertical", "aggregate8_diagonal",
             "aggregate_horizontal", "aggregate_vertical")
    recs = []
    for name, (xs, p2s, p1, shift, diag) in zip(names, batches):
        got = sgm.sgm_scan(xs, p2s, p1, shift, diag)
        want = sgm._scan_passes_plain(xs, p2s, p1, shift, diag)
        torch.cuda.synchronize()
        nbytes = (2 * xs.numel() + p2s.numel()) * 4
        flops = 8 * xs.numel()  # per cell: the min, two mins and adds, the sub
        rec = {"phase": "sgm", "kernel": "sgm_scan", "batch": name,
               "shape": list(xs.shape), "shift": shift, "diag": bool(diag),
               "bit_equal": bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
               "max_abs_err": float((got - want).abs().max()),
               "ms": cuda_ms(lambda: sgm.sgm_scan(xs, p2s, p1, shift, diag), 20, graph=True),
               "eager_ms": cuda_ms(lambda: sgm.sgm_scan(xs, p2s, p1, shift, diag), 20),
               "plain_ms": cuda_ms(lambda: sgm._scan_passes_plain(xs, p2s, p1, shift, diag),
                                   2),
               "bytes": nbytes, "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
               "bound_by": "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_FP32 else "operations",
               "library_ms": None,
               "library_note": "no single PyTorch call computes an SGM directional pass",
               "card": card}
        emit(rec)
        recs.append(rec)
    if len(recs) != len(names) or not all(r["bit_equal"] for r in recs):
        raise RuntimeError("sgm_scan differs from _scan_passes_plain")
    row = {k: sum(r[k] for r in recs[:3]) for k in ("ms", "eager_ms", "plain_ms", "bound_ms")}
    row.update(bound_by="bytes", library_ms=None, batches=3,
               max_abs_err=max(r["max_abs_err"] for r in recs))
    return recs, row


def _wzncc_args(rectA, rectB, hs, ws, num_d, l_min, seed):
    """wzncc_volume_masked's operands for one level of a pair on the card:
    both matches of the pair at (hs, ws) (weights of the two images, the
    right images as the other match's left), their d_mins (l_min and the
    right match's) and seeded per-pixel windows in the volume's range."""
    import numpy as np
    import torch

    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.ops import sgm

    A, B = ((im if im.shape == (hs, ws) else imio.resize_area(im, ws, hs))
            for im in (rectA, rectB))
    imgs = torch.as_tensor(np.stack([A, B]).astype(np.float32), device="cuda")
    d_mins = [l_min, -(l_min + num_d - 1)]
    rng = np.random.default_rng(seed)
    lo = np.stack([d + rng.integers(0, num_d // 2, (hs, ws)) for d in d_mins])
    hi = lo + rng.integers(1, num_d, (2, hs, ws))
    dev = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device="cuda")
    return (*sgm.wzncc_weights(imgs), imgs.flip(0).contiguous(),
            dev(d_mins, np.int32), num_d, dev(lo, np.int16), dev(hi, np.int16))


def _wzncc_rows(card, rectA, rectB, d_lo):
    """wzncc_volume against its plain version on the card at the level
    shapes of the phase's pairs, (2, 240, 320) with D 32 and 64 and (2,
    480, 640) with D 64 and 128, each from the phase's pair with the
    level's l_min and seeded windows: bit for bit, CUDA-event ms of a graph
    replay and of eager launches, plain ms and the bound (bytes: each input
    read once, the volume written once; operations: fp32 at 67 TFLOP/s plus
    fp64 at 34). Returns the records and the kernels line's row: the (2,
    480, 640) level with D = 64."""
    import numpy as np
    import torch

    from openmvs_tpu_torch.ops import sgm

    recs = []
    T = 49
    for hs, ws, num_d in ((240, 320, 32), (240, 320, 64), (480, 640, 64), (480, 640, 128)):
        l_min = int(np.floor(d_lo * hs / rectA.shape[0])) - 8
        args = _wzncc_args(rectA, rectB, hs, ws, num_d, l_min, seed=num_d + hs)
        got = sgm.wzncc_volume_masked(*args)
        want = sgm._wzncc_volume_plain(*args, 3, 3)
        torch.cuda.synchronize()
        px = 2 * hs * ws
        nbytes = (2 * T + 3) * px * 4 + 2 * px * 2 + 2 * 4 + px * num_d
        fp32 = px * num_d * (WZNCC_FLOP_TEXEL * T + WZNCC_FLOP_EPILOGUE)
        fp64 = px * num_d * WZNCC_FLOP64
        t_ops = fp32 / PEAK_FP32 + fp64 / PEAK_FP64
        rec = {"phase": "sgm", "kernel": "wzncc_volume", "shape": [2, hs, ws, num_d],
               "l_min": l_min, "bit_equal": bool(torch.equal(got, want)),
               "max_abs_err": float((got.int() - want.int()).abs().max()),
               "ms": cuda_ms(lambda: sgm.wzncc_volume_masked(*args), 20, graph=True),
               "eager_ms": cuda_ms(lambda: sgm.wzncc_volume_masked(*args), 20),
               "plain_ms": cuda_ms(lambda: sgm._wzncc_volume_plain(*args, 3, 3), 2),
               "bytes": nbytes, "fp32_ops": fp32, "fp64_ops": fp64,
               "bound_ms": max(nbytes / PEAK_BYTES, t_ops) * 1e3,
               "bound_by": "bytes" if nbytes / PEAK_BYTES >= t_ops else "operations",
               "library_ms": None,
               "library_note": "no single PyTorch call computes a bilateral-weighted "
                               "ZNCC cost volume", "card": card}
        emit(rec)
        recs.append(rec)
    if not all(r["bit_equal"] for r in recs):
        raise RuntimeError("wzncc_volume differs from its plain version")
    row = dict(recs[2])
    return recs, row


def _host_ms(fn, reps):
    """Mean host-clock ms of ``fn`` over ``reps`` calls after one warm-up
    call, each ending in a synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _rectify_rows(card, scene):
    """rectify_warp against the host warp (io/images.warp_perspective) on
    the card, on view 0's pair with its best neighbour at the scene's size
    and at the benchmark's 800x600 (the same warp: both homographies
    conjugated by the scale, random sources): bit for bit; the kernel's
    mean ms over the launches torch.profiler records of 20 (after an
    earlier profile in the process it may miss the first), a graph
    replay's and eager launches' CUDA-event ms; the card step's host-clock
    ms (NumPy sources uploaded, one launch, the pair downloaded:
    rectify_pair's card path less its 3x3 algebra) against the host warp
    of both images; at the scene's size rectify_pair itself, on the card
    and on the host; and the bound (bytes: both sources read once, both
    images written once). Returns the records and the kernels line's row
    (800x600)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from openmvs_tpu_torch.io.images import warp_perspective
    from openmvs_tpu_torch.ops import rectify_kernel, sgm

    dev = torch.device("cuda")
    img = scene.images[0]
    nb = next(im for im in scene.images if im.meta.id == img.meta.view_scores[0].id)
    camA, camB = img.working_camera(), nb.working_camera()
    _, _, info = sgm.rectify_pair(camA, camB, img.gray, nb.gray)
    h, w = img.gray.shape
    rng = np.random.default_rng(800)
    recs = []
    for H, W in ((h, w), (600, 800)):
        if (H, W) == (h, w):
            srcs = [np.asarray(img.gray, np.float32), np.asarray(nb.gray, np.float32)]
            Ts = [info["TA"], info["TB"]]
        else:
            srcs = [rng.uniform(0, 1, (H, W)).astype(np.float32) for _ in range(2)]
            S = np.diag([W / w, H / h, 1.0])
            Ts = [S @ info[k] @ np.linalg.inv(S) for k in ("TA", "TB")]
        on_card = [torch.from_numpy(s).to(dev) for s in srcs]

        def launch():
            return rectify_kernel.warp_pair(*on_card, *Ts, W, H)

        def step():
            return rectify_kernel.warp_pair(
                *(torch.as_tensor(s, device=dev) for s in srcs), *Ts, W, H).cpu().numpy()

        got = step()
        want, host_s = _wall_s(lambda: [warp_perspective(s, T, W, H)
                                        for s, T in zip(srcs, Ts)])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
        kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "rectify_warp" in e.name]
        nbytes = 4 * (srcs[0].size + srcs[1].size) + 4 * 2 * H * W
        rec = {"phase": "sgm", "kernel": "rectify_warp", "shape": [2, H, W],
               "bit_equal": all(np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32))
                                for k in range(2)),
               "max_abs_err": max(float(np.abs(got[k] - want[k]).max()) for k in range(2)),
               "ms": sum(kernel_us) / len(kernel_us) / 1e3 if kernel_us else None,
               "profiled_launches": len(kernel_us),
               "graph_ms": cuda_ms(launch, 20, graph=True), "eager_ms": cuda_ms(launch, 20),
               "step_ms": _host_ms(step, 20), "plain_ms": host_s * 1e3,
               "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
               "library_ms": None,
               "library_note": "no PyTorch call repeats OpenCV's warp to the bit",
               "card": card}
        if (H, W) == (h, w):
            rec["rectify_pair_card_ms"] = _host_ms(
                lambda: sgm.rectify_pair(camA, camB, img.gray, nb.gray, device=dev), 20)
            _, host_s = _wall_s(lambda: sgm.rectify_pair(camA, camB, img.gray, nb.gray))
            rec["rectify_pair_host_ms"] = host_s * 1e3
        emit(rec)
        recs.append(rec)
    if not all(r["bit_equal"] for r in recs):
        raise RuntimeError("rectify_warp differs from the host warp")
    if not all(r["profiled_launches"] for r in recs):
        raise RuntimeError("the profiler saw no rectify_warp launch")
    return recs, dict(recs[1])


def _sgm_scan_wide_rows(card):
    """sgm_scan past the register path, D 257, 384 and 512, on a small
    batch (2, 60, 80) of seeded integer costs: vertical (shift 0) and
    diagonal (shift 1, diag) passes against _scan_passes_plain on the card,
    bit for bit, with ms (graph replay), plain ms and the bytes bound."""
    import numpy as np
    import torch

    from openmvs_tpu_torch.ops import sgm

    rng = np.random.default_rng(257)
    recs = []
    for D in (257, 384, 512):
        for shift, diag in ((0, False), (1, True)):
            xs = torch.as_tensor(rng.integers(0, 256, (2, 60, 80, D)).astype(np.float32),
                                 device="cuda")
            p2s = torch.as_tensor(rng.uniform(4, 60, (2, 60, 80)).astype(np.float32),
                                  device="cuda")
            got = sgm.sgm_scan(xs, p2s, 3.0, shift, diag)
            want = sgm._scan_passes_plain(xs, p2s, 3.0, shift, diag)
            torch.cuda.synchronize()
            nbytes = (2 * xs.numel() + p2s.numel()) * 4
            rec = {"phase": "sgm", "kernel": "sgm_scan", "batch": "wide",
                   "shape": list(xs.shape), "shift": shift, "diag": diag,
                   "bit_equal": bool(torch.equal(got.view(torch.int32),
                                                 want.view(torch.int32))),
                   "max_abs_err": float((got - want).abs().max()),
                   "ms": cuda_ms(lambda: sgm.sgm_scan(xs, p2s, 3.0, shift, diag), 5,
                                 graph=True),
                   "plain_ms": cuda_ms(
                       lambda: sgm._scan_passes_plain(xs, p2s, 3.0, shift, diag), 1),
                   "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
                   "bound_by": "bytes", "card": card}
            emit(rec)
            recs.append(rec)
    if not all(r["bit_equal"] for r in recs):
        raise RuntimeError("sgm_scan past 256 disparities differs from _scan_passes_plain")
    return recs


def _sgm_wide_pair(card, rectA, rectB, d_lo, d_hi):
    """match_pair_tsgm(max_num_d=512) on the phase's pair brought to
    120x160, its range widened by 150 px each way and every level's volume
    512 deep (OMVS_SGM_ND_LADDER=16,512), on the card and on the CPU:
    disparities and costs equal."""
    import numpy as np
    import torch

    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.ops import pm_kernel, sgm

    A, B = (imio.resize_area(im, 160, 120) for im in (rectA, rectB))
    lo, hi = int(np.floor(d_lo / 4)) - 150, int(np.ceil(d_hi / 4)) + 150
    prev = os.environ.get("OMVS_SGM_ND_LADDER")
    os.environ["OMVS_SGM_ND_LADDER"] = "16,512"
    try:
        levels = []
        pm_kernel.reset_launches()
        t0 = time.perf_counter()
        dc, cc = sgm.match_pair_tsgm(A, B, lo, hi, max_num_d=512, device="cuda",
                                     stats=levels)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k: v for k, v in pm_kernel.LAUNCHES.items() if v}
        t0 = time.perf_counter()
        dh, ch = sgm.match_pair_tsgm(A, B, lo, hi, max_num_d=512, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("OMVS_SGM_ND_LADDER")
        else:
            os.environ["OMVS_SGM_ND_LADDER"] = prev
    rec = {"phase": "sgm", "check": "max_num_d 512", "hw": [120, 160], "d_range": [lo, hi],
           "level_num_d": [lv["num_d"] for lv in levels], "launches": launches,
           "disparity_equal": bool(np.array_equal(dc, dh, equal_nan=True)),
           "cost_equal": bool(np.array_equal(cc.view(np.int32), ch.view(np.int32))),
           "valid_share": float(np.isfinite(dc).mean()), "card_s": card_s, "cpu_s": cpu_s,
           "card": card}
    emit(rec)
    if not (rec["disparity_equal"] and rec["cost_equal"]):
        raise RuntimeError("match_pair_tsgm(max_num_d=512): card and CPU differ")
    if max(rec["level_num_d"]) <= 256:
        raise RuntimeError(f"max_num_d 512 ran levels of {rec['level_num_d']} disparities")
    return rec


def phase_sgm(card, scene, gts):
    """The SGM estimator on the card: dense_reconstruction with
    DenseOptions(estimator="sgm") at full width (each level a CUDA graph of
    its shape class, captured once per call), its quality against the JAX
    package's, the .dimap export (fusion_mode=-1) and resume (-2), one
    full-width pair graphed, eager and on the CPU, that pair profiled both
    ways, the kernels against their plain versions (sgm_scan also past 256
    disparities), and a 512-disparity pair on the card against the CPU."""
    import numpy as np
    import torch

    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import graphs, sgm
    from openmvs_tpu_torch.synthetic import depth_quality

    n = len(scene.images)
    opts = DenseOptions(estimator="sgm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        pc, wall, stages, pairs, launches, call_graphs = _sgm_dense(scene, opts, tmp)
        peak = torch.cuda.max_memory_allocated()
        maps = _dmaps(tmp, n)
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    est_s = sum(v for k, v in stages.items() if k.startswith("photometric pass"))
    call_graphs["pairs_of_captured_classes"] = _check_captured_classes(pairs)

    with tempfile.TemporaryDirectory() as tmp:
        pc_x, wall_x, _, pairs_x, _, _ = _sgm_dense(scene, DenseOptions(), tmp,
                                                    fusion_mode=-1)
        dimaps = sorted(f for f in os.listdir(tmp) if f.endswith(".dimap"))
        pc_r, wall_r, _, pairs_r, _, _ = _sgm_dense(scene, opts, tmp, fusion_mode=-2)
        for f in os.listdir(tmp):
            if f.endswith(".dmap"):
                os.remove(os.path.join(tmp, f))
        pc_d, wall_d, _, pairs_d, _, _ = _sgm_dense(scene, opts, tmp, fusion_mode=-2)
    export = {"export_points": len(pc_x), "export_wall_s": wall_x,
              "dimap_files": len(dimaps), "pairs_matched": len(pairs_x),
              "resume_wall_s": wall_r, "resume_points": len(pc_r),
              "resume_pairs_matched": len(pairs_r),
              "resume_cloud_equal": bool(len(pc_r) == len(pc) and np.array_equal(
                  np.asarray(pc_r.points), np.asarray(pc.points))),
              "dimap_resume_wall_s": wall_d, "dimap_resume_points": len(pc_d),
              "dimap_resume_pairs_matched": len(pairs_d)}

    rectA, rectB, d_lo, d_hi = _sgm_pair(scene, 0)
    levels = []
    disp_c, cost_c = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cuda",
                                         stats=levels)
    # graphed: each level's first run eager, the second captured, the
    # third replayed
    runners = graphs.Runners()
    graphed = [sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cuda",
                                   runners=runners) for _ in range(3)]
    pair_graphs = _graph_summary([runners])
    t0 = time.perf_counter()
    disp_h, cost_h = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cpu")
    cpu_s = time.perf_counter() - t0
    vs_cpu = {"disparity_equal": bool(np.array_equal(disp_c, disp_h, equal_nan=True)),
              "cost_equal": bool(np.array_equal(cost_c, cost_h)),
              "graphed_equal_eager": [
                  bool(np.array_equal(d, disp_c, equal_nan=True)
                       and np.array_equal(c.view(np.int32), cost_c.view(np.int32)))
                  for d, c in graphed],
              "graphs": pair_graphs,
              "valid_share": float(np.isfinite(disp_c).mean()),
              "d_range": [d_lo, d_hi], "levels": levels, "cpu_s": cpu_s,
              "cpu_threads": torch.get_num_threads()}
    prof = _profile_sgm_pair(rectA, rectB, d_lo, d_hi)
    prof_graphed = _profile_sgm_pair(rectA, rectB, d_lo, d_hi, runners=runners)
    del runners
    _, scan_row = _sgm_scan_rows(card, rectA, rectB, d_lo, d_hi)
    _sgm_scan_wide_rows(card)
    _, wzncc_row = _wzncc_rows(card, rectA, rectB, d_lo)
    wide = _sgm_wide_pair(card, rectA, rectB, d_lo, d_hi)
    _, rectify_row = _rectify_rows(card, scene)

    H, W = scene.images[0].gray.shape
    rec = {"phase": "sgm", "views": n, "H": H, "W": W,
           "options": 'DenseOptions(estimator="sgm")', "num_dirs": opts.sgm_num_dirs,
           "subpixel_mode": opts.sgm_subpixel_mode, "depth_maps": len(maps),
           "wall_s": wall, "depth_maps_per_s": len(maps) / wall,
           "estimate_s": est_s,
           "estimate_depth_maps_per_s": len(maps) / est_s if est_s else None,
           "stages_s": stages, "points": len(pc), "pairs": len(pairs),
           "pair_s": [p["seconds"] for p in pairs],
           "level_s": [[lv["seconds"] for lv in p["levels"]] for p in pairs],
           "level_hw_num_d": [[lv["hw"] + [lv["num_d"]] for lv in p["levels"]]
                              for p in pairs],
           "max_memory_allocated_bytes": peak, "kernel_launches": launches,
           "sgm_scan_launches": launches["sgm_scan"], "sgm_scan_aggregate8": scan_row,
           "wzncc_volume_launches": launches["wzncc_volume"],
           "rectify_warp_launches": launches["rectify_warp"], "graphs": call_graphs,
           "accuracy": [a for a, _ in q], "completeness": [c for _, c in q],
           "jax_accuracy": JAX_SGM_ACCURACY, "jax_completeness": JAX_SGM_COMPLETENESS,
           "export_resume": export, "pair_card_vs_cpu": vs_cpu, "pair_profile": prof,
           "pair_profile_graphed": prof_graphed, "max_num_d_512": wide,
           "card": card}
    emit(rec)
    if len(pc) == 0 or len(maps) != n:
        raise RuntimeError(f"SGM densify gave {len(maps)} maps and {len(pc)} points")
    if any(n for k, n in launches.items()
           if k not in ("sgm_scan", "wzncc_volume", "rectify_warp")):
        raise RuntimeError(f"the SGM path launched PatchMatch kernels: {launches}")
    if launches["rectify_warp"] != len(pairs):
        raise RuntimeError(f"{launches['rectify_warp']} rectify_warp launches for "
                           f"{len(pairs)} pairs matched on the card")
    for i, (acc, comp) in enumerate(q):
        if acc < 0.95 * JAX_SGM_ACCURACY[i] or comp < 0.95 * JAX_SGM_COMPLETENESS[i]:
            raise RuntimeError(f"view {i}: SGM quality {(acc, comp)} below 95% of the "
                               f"JAX package's ({JAX_SGM_ACCURACY[i]}, "
                               f"{JAX_SGM_COMPLETENESS[i]})")
    if not (export["export_points"] == 0 and export["dimap_files"] == len(pairs)
            and export["pairs_matched"] == len(pairs) and export["resume_cloud_equal"]
            and export["resume_pairs_matched"] == 0
            and export["dimap_resume_pairs_matched"] == 0
            and len(pc_d) > 0):
        raise RuntimeError(f"SGM export/resume failed: {export}")
    if not (vs_cpu["disparity_equal"] and vs_cpu["cost_equal"]):
        raise RuntimeError("SGM pair: card and CPU disparities or costs differ")
    if not all(vs_cpu["graphed_equal_eager"]):
        raise RuntimeError(f"SGM pair: graphed runs differ from the eager one: "
                           f"{vs_cpu['graphed_equal_eager']}")
    if not (pair_graphs["captures"] and pair_graphs["replays"]):
        raise RuntimeError(f"SGM pair: no level captured or replayed: {pair_graphs}")
    if (prof_graphed["captures"] or not prof_graphed["graph_replays"]
            or prof_graphed["host_kernel_launches"] >= prof["host_kernel_launches"]):
        raise RuntimeError(f"SGM pair graphed: {prof_graphed['captures']} captures, "
                           f"{prof_graphed['graph_replays']} replays, "
                           f"{prof_graphed['host_kernel_launches']} host launches against "
                           f"{prof['host_kernel_launches']} eager")
    if not (launches["sgm_scan"] and launches["wzncc_volume"]):
        raise RuntimeError(f"the SGM path launched no sgm_scan or wzncc_volume: {launches}")
    if not (call_graphs["captures"] and call_graphs["replays"]):
        raise RuntimeError(f"the SGM call captured or replayed no level: {call_graphs}")
    return {"sgm_scan": scan_row, "wzncc_volume": wzncc_row,
            "rectify_warp": rectify_row}, launches


def _reconstruct(scene, pc):
    """reconstruct_mesh(scene, MeshOptions(), pc): the mesh, the call's
    seconds and its stage log."""
    from openmvs_tpu_torch import reconstruct
    from openmvs_tpu_torch.config import MeshOptions

    stage_log = _StageLog()
    logger = logging.getLogger("omvs_torch.reconstruct")
    logger.addHandler(stage_log)
    try:
        t0 = time.perf_counter()
        mesh = reconstruct.reconstruct_mesh(scene, MeshOptions(), pc=pc)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(stage_log)
    return mesh, wall, stage_log


def _obj_text(x):
    """float32 of ``x`` as the OBJ writer's 6 decimals give it back."""
    import numpy as np

    return np.array([float(f"{c:.6f}") for c in np.asarray(x).ravel()],
                    np.float32).reshape(np.shape(x))


def _save_and_read_back(pc, clean, refined, textured):
    """Save the dense cloud, the clean and refined meshes (PLY) and the
    textured mesh (OBJ, MTL and PNG pages) into a temporary directory and
    read them back with the port's loaders: per file its bytes, and
    whether what came back equals what was saved (an OBJ holds 6 decimals,
    so its vertices and texcoords are compared with that text's values;
    its faces come back grouped by atlas page)."""
    import numpy as np

    from openmvs_tpu_torch.io import obj as objio
    from openmvs_tpu_torch.io import ply as plyio
    from openmvs_tpu_torch.io import png
    from openmvs_tpu_torch.scene import Scene

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = Scene()
        scene.pointcloud = pc
        scene.save_pointcloud(os.path.join(tmp, "dense.ply"))
        d = plyio.load(os.path.join(tmp, "dense.ply"))
        ok = np.array_equal(d.vertices, pc.points)
        if pc.has_normals:
            v = d.elements["vertex"]
            ok &= np.array_equal(np.stack([v["nx"], v["ny"], v["nz"]], -1), pc.normals)
        out["dense.ply"] = bool(ok)
        for name, mesh in (("clean.ply", clean), ("refined.ply", refined)):
            scene.mesh = mesh
            scene.save_mesh(os.path.join(tmp, name))
            back = Scene()
            back.load_mesh(os.path.join(tmp, name))
            out[name] = bool(np.array_equal(back.mesh.vertices, mesh.vertices)
                             and np.array_equal(back.mesh.faces, mesh.faces))
        scene.mesh = textured
        scene.save_mesh(os.path.join(tmp, "textured.obj"))
        v, f, tc, tex = objio.load_mesh_obj(os.path.join(tmp, "textured.obj"))
        pages = textured.textures or [textured.texture]
        fp = (np.asarray(textured.face_page) if textured.face_page is not None
              else np.zeros(len(textured.faces), np.int64))
        order = np.argsort(fp, kind="stable")
        out["textured.obj"] = bool(
            np.array_equal(v, _obj_text(textured.vertices))
            and np.array_equal(f, textured.faces[order])
            and np.array_equal(tc, _obj_text(textured.face_tex_coords[order])))
        names = ["textured.png"] + [f"textured_{p}.png" for p in range(1, len(pages))]
        out["textured pages"] = bool(
            np.array_equal(tex, pages[-1])
            and all(np.array_equal(png.read(os.path.join(tmp, n)), p)
                    for n, p in zip(names, pages)))
        sizes = {n: os.path.getsize(os.path.join(tmp, n)) for n in sorted(os.listdir(tmp))}
    return out, sizes


def phase_pipeline(card, scene, colored, pc):
    """The whole chain on the port: phase densify's cloud meshed
    (reconstruct_mesh, host), cleaned (clean_mesh(decimate=0.5), host),
    refined on the card (refine_mesh, RefineOptions(scales=2, iters=16)),
    textured on the card (texture_mesh, TextureOptions(), on the scene
    with its colors), saved and read back; held to the JAX package's
    figures for the same chain."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import mesh_ops, native, refine
    from openmvs_tpu_torch.config import RefineOptions

    t_phase = time.perf_counter()
    native.build()
    mesh, mesh_s, log = _reconstruct(scene, pc)
    dedup = [re.match(r"dedup: (\d+) -> (\d+) points", m) for m in log.messages]
    dedup = [m for m in dedup if m][0]
    tets = [re.match(r"(\d+) points -> (\d+) tets", m) for m in log.messages]
    tets = [m for m in tets if m][0]
    mesh2, mesh2_s, _ = _reconstruct(scene, pc)
    rerun_equal = bool(np.array_equal(mesh.faces, mesh2.faces)
                       and np.array_equal(mesh.vertices, mesh2.vertices))

    t0 = time.perf_counter()
    clean = mesh_ops.clean_mesh(mesh, decimate=0.5)
    clean_s = time.perf_counter() - t0

    rstats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    refined = refine.refine_mesh(scene, clean, RefineOptions(scales=2, iters=16),
                                 device="cuda", stats=rstats)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    refine_peak = torch.cuda.max_memory_allocated()

    textured, tstats, texture_s, texture_peak = _texture_run(colored, refined, "cuda")
    tex = _texture_summary(textured, tstats, texture_s, texture_peak, colored, refined)
    t0 = time.perf_counter()
    saved, sizes = _save_and_read_back(pc, clean, refined, textured)
    save_s = time.perf_counter() - t0

    q_clean = _mesh_height_quality(clean.vertices)
    q_refined = _mesh_height_quality(refined.vertices)
    H, W = scene.images[0].gray.shape
    rec = {"phase": "pipeline", "views": len(scene.images), "H": H, "W": W,
           "mesh": {"points": len(pc),
                    "points_after_dedup": int(dedup.group(2)),
                    "tets": int(tets.group(2)), "raw_faces": len(mesh.faces),
                    "raw_vertices": len(mesh.vertices), "wall_s": mesh_s,
                    "stages_s": log.stages, "rerun_wall_s": mesh2_s,
                    "rerun_equal": rerun_equal, "omp_num_threads":
                    os.environ.get("OMP_NUM_THREADS"), "host_cpus": os.cpu_count()},
           "clean": {"faces": len(clean.faces), "vertices": len(clean.vertices),
                     "wall_s": clean_s, "height_error": q_clean[0],
                     f"within_{HEIGHT_TOL}": q_clean[1], "domain_vertices": q_clean[2]},
           "refine": {"options": "RefineOptions(scales=2, iters=16)", "wall_s": refine_s,
                      "scales": rstats["scales"], "pairs": rstats["pairs"],
                      "host_s": rstats["host_s"], "max_memory_allocated_bytes": refine_peak,
                      "faces": len(refined.faces), "height_error": q_refined[0],
                      f"within_{HEIGHT_TOL}": q_refined[1]},
           "texture": tex, "saved_equal": saved, "file_bytes": sizes,
           "save_and_read_back_s": save_s, "phase_s": time.perf_counter() - t_phase,
           "jax": {"raw_faces": JAX_RAW_FACES, "clean_faces": JAX_CLEAN_FACES,
                   "clean_height_error": JAX_CLEAN_HEIGHT_ERROR,
                   "clean_within": JAX_CLEAN_WITHIN,
                   "refined_height_error": JAX_REFINED_HEIGHT_ERROR,
                   "refined_within": JAX_REFINED_WITHIN,
                   "color_fidelity": JAX_PIPELINE_FIDELITY,
                   f"faces_within_{FIDELITY_BOUND}": JAX_PIPELINE_WITHIN},
           "card": card}
    emit(rec)
    for what, got, ref in (("raw faces", len(mesh.faces), JAX_RAW_FACES),
                           ("clean faces", len(clean.faces), JAX_CLEAN_FACES)):
        if abs(got - ref) > 0.05 * ref:
            raise RuntimeError(f"{what} {got}: not within 5% of the JAX package's {ref}")
    if not q_clean[0] <= 1.05 * JAX_CLEAN_HEIGHT_ERROR:
        raise RuntimeError(f"clean mesh height error {q_clean[0]} above 1.05x the JAX "
                           f"package's {JAX_CLEAN_HEIGHT_ERROR}")
    if not q_clean[1] >= 0.98 * JAX_CLEAN_WITHIN:
        raise RuntimeError(f"clean mesh share within {HEIGHT_TOL} {q_clean[1]} below 0.98x "
                           f"the JAX package's {JAX_CLEAN_WITHIN}")
    if not q_refined[0] <= q_clean[0]:
        raise RuntimeError(f"refinement raised the height error: {q_clean[0]} -> {q_refined[0]}")
    if not np.isfinite(np.asarray(refined.vertices)).all():
        raise RuntimeError("refine produced non-finite vertices")
    if not tex["color_fidelity"] <= 1.02 * JAX_PIPELINE_FIDELITY:
        raise RuntimeError(f"color fidelity {tex['color_fidelity']} above 1.02x the JAX "
                           f"package's {JAX_PIPELINE_FIDELITY}")
    within = tex[f"faces_within_{FIDELITY_BOUND}"]
    if not within >= 0.98 * JAX_PIPELINE_WITHIN:
        raise RuntimeError(f"{within} of faces within {FIDELITY_BOUND} of their source color, "
                           f"below 0.98x the JAX package's {JAX_PIPELINE_WITHIN}")
    if not all(saved.values()):
        raise RuntimeError(f"saved files read back differently: {saved}")
    return textured


def _cli(args, timeout=900):
    """``python -m openmvs_tpu_torch <args>`` in a process of its own, from
    the checkout: (wall s, {stage: s} from its log, its log lines). Raises
    with the end of its output where it fails."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "openmvs_tpu_torch"] + args, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"python -m openmvs_tpu_torch {' '.join(args)} exited "
                           f"{r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    lines = [ln.split(": ", 1)[1] for ln in r.stderr.splitlines() if ": " in ln]
    stages = {}
    for ln in lines:
        m = re.match(r"(.*) \(([0-9.]+)s\)$", ln)
        if m:
            stages[m.group(1)] = float(m.group(2))
    return wall, stages, lines


def _peak(lines):
    found = [int(m.group(1)) for m in
             (re.match(r"peak device memory (\d+) bytes", ln) for ln in lines) if m]
    return found[-1] if found else None


def _clouds_equal(a, b):
    import numpy as np

    return bool(np.array_equal(a.points, b.points)
                and len(a.views) == len(b.views)
                and all(np.array_equal(x, y) for x, y in zip(a.views, b.views))
                and all(np.array_equal(x, y) for x, y in zip(a.weights, b.weights))
                and np.array_equal(a.normals, b.normals)
                and np.array_equal(a.colors, b.colors))


def _time_loading(scene, out_mvs):
    """Seconds of the loading layer over the scene's images and its .mvs:
    decoding (io/images.load_color), the area resize to densify's 640x480,
    to_gray at that size, Scene.load of the .mvs and Scene.save of it."""
    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.scene import Scene

    t = {"decode": 0.0, "resize_area": 0.0, "to_gray": 0.0}
    for img in scene.images:
        t0 = time.perf_counter()
        color = imio.load_color(img.path)
        t1 = time.perf_counter()
        small = imio.resize_area(color, color.shape[1] // 2, color.shape[0] // 2)
        t2 = time.perf_counter()
        imio.to_gray(small)
        t3 = time.perf_counter()
        t["decode"] += t1 - t0
        t["resize_area"] += t2 - t1
        t["to_gray"] += t3 - t2
    t0 = time.perf_counter()
    scene.save(out_mvs)
    t["mvs_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Scene.load(out_mvs)
    t["mvs_read"] = time.perf_counter() - t0
    return t


def _move_matrix():
    """The 3x4 similarity phase imports moves the dense scene by before
    aligning it back: a rotation of 0.3 rad about (1, 2, 2) / 3 (Rodrigues),
    scale 1.3 and a shift."""
    import numpy as np

    k = np.array([1.0, 2.0, 2.0]) / 3.0
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(0.3) * Kx + (1 - np.cos(0.3)) * Kx @ Kx
    return np.concatenate([1.3 * R, [[0.7], [-1.1], [0.25]]], axis=1)


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _quiet(main, args):
    """``main(args)`` with its standard output kept out of this script's:
    (seconds, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(args)
    return time.perf_counter() - t0, buf.getvalue()


def _fscores(path):
    """The F-scores at 1, 2, 5 and 10 cm of an ``eval -o`` JSON file."""
    with open(path) as f:
        res = json.load(f)
    return {k: res[f"fscore@{k}"] for k in ("1cm", "2cm", "5cm", "10cm")}, res


def _host_steps(main, scene_dir, dense_mvs, work, densify_args=()):
    """The host steps of phase imports on a dense scene, through the CLI
    entry ``main`` (the port's or the JAX package's, in this process):
    ``eval --est`` of the dense cloud against the scene's scan;
    ``transform --matrix`` by _move_matrix(), then ``transform --align-file``
    back (the error of the recovered similarity: max |T_back M - I| with
    T_back from the camera centres before and after, and the largest move
    of a camera centre); ``transform --max-resolution 640`` (the sha256 of
    each rescaled image); ``transform --compute-volume`` with the height
    field's 96-grid as the mesh (its printed volume, and the same by
    ``Scene.compute_leveled_volume`` in full precision); ``densify
    --split-max-points 100000`` (each chunk's points and views). Returns
    (results, seconds)."""
    import numpy as np

    from openmvs_tpu_torch.geometry.similarity import umeyama
    from openmvs_tpu_torch.io import mvs as mvsio
    from openmvs_tpu_torch.io.images import image_size
    from openmvs_tpu_torch.io import ply as plyio
    from openmvs_tpu_torch.scene import Scene
    from openmvs_tpu_torch.synthetic import height_field_mesh

    def path(name):
        return os.path.join(work, name)

    def centres(mvs):
        itf = mvsio.load(mvs)
        return np.stack([itf.platforms[m.platform_id].poses[m.pose_id].C
                         for m in itf.images]).astype(np.float64)

    secs, res = {}, {}
    secs["eval_est"], _ = _quiet(main, ["eval", "--dataset", "eth3d", "--scene", scene_dir,
                                        "--est", dense_mvs.replace(".mvs", ".ply"),
                                        "-o", path("eval_est.json")])
    res["est_fscores"], _ = _fscores(path("eval_est.json"))
    M = np.eye(4)
    M[:3] = _move_matrix()
    np.savetxt(path("move.txt"), M[:3])
    secs["transform_matrix"], _ = _quiet(main, ["transform", dense_mvs, "--matrix",
                                                path("move.txt"), "-o", path("moved.mvs")])
    secs["transform_align"], _ = _quiet(main, ["transform", path("moved.mvs"), "--align-file",
                                               dense_mvs, "-o", path("back.mvs")])
    c0, c1, c2 = centres(dense_mvs), centres(path("moved.mvs")), centres(path("back.mvs"))
    T_back, _ = umeyama(c1, c2)
    res["align_matrix_error"] = float(np.abs(T_back @ M - np.eye(4)).max())
    res["align_centre_error"] = float(np.abs(c2 - c0).max())
    secs["transform_scale"], _ = _quiet(main, ["transform", dense_mvs, "--max-resolution",
                                               "640", "-o", path("scaled.mvs")])
    scaled = Scene.load(path("scaled.mvs"))
    res["scaled"] = {os.path.basename(im.path): _sha256(im.path) for im in scaled.images}
    res["scaled_sizes"] = sorted({image_size(im.path) for im in scaled.images})
    mesh = height_field_mesh(96)
    plyio.save_mesh(path("height_field.ply"), mesh.vertices, mesh.faces)
    secs["transform_volume"], out = _quiet(main, ["transform", dense_mvs, "--mesh-file",
                                                  path("height_field.ply"), "--compute-volume",
                                                  "-o", path("leveled.mvs")])
    res["volume_printed"] = float(re.search(r"mesh volume: (\S+)", out).group(1))
    scene = Scene.load(dense_mvs)
    scene.mesh = mesh
    res["volume"] = scene.compute_leveled_volume()
    split_dir = os.path.join(work, "split")
    os.makedirs(split_dir, exist_ok=True)
    secs["split"], out = _quiet(main, ["densify", dense_mvs, "--split-max-points", "100000",
                                       "-o", os.path.join(split_dir, "chunk.mvs")]
                                + list(densify_args))
    chunks = []
    for name in sorted(os.listdir(split_dir)):
        itf = mvsio.load(os.path.join(split_dir, name))
        chunks.append({"name": name, "points": len(itf.points), "views": len(itf.images)})
    res["chunks"] = chunks
    return res, secs


def phase_files(card, folder):
    """The port run as a user runs it, from files, in ``folder``: the colored synthetic
    scene written as 5 JPEGs of 1280x960 (quality 95, PIL) and scene.mvs,
    densify through ``openmvs_tpu_torch.__main__.main`` in this process
    (launch counts set to 0 just before and read just after), then mesh,
    refine and texture as ``python -m openmvs_tpu_torch`` commands; held
    to the JAX package's CLI figures on the same files (JAX_CLI)."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import __main__ as cli
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.io import obj as objio
    from openmvs_tpu_torch.io import ply as plyio
    from openmvs_tpu_torch.ops import pm_kernel
    from openmvs_tpu_torch.scene import Mesh, Scene
    from openmvs_tpu_torch.synthetic import write_scene_files

    t_phase = time.perf_counter()
    tmp = folder
    t0 = time.perf_counter()
    mvs, digests, _, _ = write_scene_files(tmp, 5, 1280, 960)
    build_s = time.perf_counter() - t0
    for name, digest in sorted(digests.items()):
        print(f"sha256 {name} {digest}", flush=True)

    def path(name):
        return os.path.join(tmp, name)

    # densify in this process, through the CLI's main
    held = {}
    dense = densify.dense_reconstruction

    def keep(scene, *a, **kw):
        held["pc"] = dense(scene, *a, **kw)
        held["views"] = [(im.width, im.height, im.gray.shape) for im in scene.images]
        return held["pc"]

    stage_log = _StageLog()
    logger = logging.getLogger("omvs_torch")
    logger.addHandler(stage_log)
    densify.dense_reconstruction = keep
    try:
        with _scoring_calls() as calls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pm_kernel.reset_launches()
            t0 = time.perf_counter()
            cli.main(["densify", mvs])
            torch.cuda.synchronize()
            densify_s = time.perf_counter() - t0
            launches = dict(pm_kernel.LAUNCHES)
    finally:
        densify.dense_reconstruction = dense
        logger.removeHandler(stage_log)
    densify_peak = torch.cuda.max_memory_allocated()
    pc = held["pc"]
    outcomes = [m for m in stage_log.messages
                if re.search(r"tower|ROI|unbounded|camera directions", m)]
    t0 = time.perf_counter()
    back = Scene.load(path("scene_dense.mvs"))
    ply_back = plyio.load(path("scene_dense.ply"))
    read_s = time.perf_counter() - t0
    dense_equal = {"scene_dense.mvs": _clouds_equal(back.pointcloud, pc),
                   "scene_dense.ply": bool(np.array_equal(ply_back.vertices, pc.points))}

    dense_mvs = path("scene_dense.mvs")
    commands = {
        "mesh": ["mesh", dense_mvs, "--decimate", "0.5", "-o", path("mesh.ply")],
        "refine": ["refine", dense_mvs, "-m", path("mesh.ply"), "--scales", "2",
                   "--iters", "16", "-o", path("refined.ply")],
        "texture": ["texture", dense_mvs, "-m", path("refined.ply"),
                    "-o", path("textured.obj")],
    }
    runs = {name: _cli(args) for name, args in commands.items()}
    raw = [re.match(r"surface: (\d+) vertices, (\d+) faces", ln)
           for ln in runs["mesh"][2]]
    raw_faces = int([m for m in raw if m][-1].group(2))
    clean = plyio.load(path("mesh.ply"))
    refined = plyio.load(path("refined.ply"))
    v, f, tc, tex = objio.load_mesh_obj(path("textured.obj"))
    textured = Mesh(vertices=v, faces=f, face_tex_coords=tc, texture=tex)
    loading = _time_loading(back, path("rewritten.mvs"))
    for img in back.images:
        img.load()
    fidelity, within = _file_color_fidelity(textured, back.images)
    sizes = {n: os.path.getsize(path(n)) for n in sorted(os.listdir(tmp))}
    q_cloud = _mesh_height_quality(pc.points)
    q_clean = _mesh_height_quality(clean.vertices)
    q_refined = _mesh_height_quality(refined.vertices)
    got = {"points": len(pc), "cloud_height_error": q_cloud[0], "cloud_within": q_cloud[1],
           "raw_faces": raw_faces, "clean_faces": len(clean.faces),
           "clean_height_error": q_clean[0], "clean_within": q_clean[1],
           "refined_height_error": q_refined[0], "refined_within": q_refined[1],
           "color_fidelity": fidelity, "faces_within": within}
    rec = {"phase": "files", "views": 5, "image_W": 1280, "image_H": 960,
           "densify_working_size": held["views"][0],
           "jpeg_sha256": digests, "jpeg_equal_to_jax_run": digests == JAX_CLI_JPEG_SHA256,
           "scene_build_s": build_s,
           "densify": {"wall_s": densify_s, "stages_s": stage_log.stages,
                       "launches": launches, "score_hypotheses_calls": calls[0],
                       "max_memory_allocated_bytes": densify_peak,
                       "tower_and_roi": outcomes, "read_back_s": read_s,
                       "saved_equal": dense_equal},
           "commands": {name: {"wall_s": w, "stages_s": st, "max_memory_allocated_bytes":
                               _peak(lines)} for name, (w, st, lines) in runs.items()},
           "loading_s": loading, "file_bytes": sizes, "results": got, "jax": JAX_CLI,
           "fidelity_bound": FIDELITY_BOUND, "height_tol": HEIGHT_TOL,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(rec)
    if held["views"][0][2] != (480, 640):
        raise RuntimeError(f"densify worked at {held['views'][0]}, not 480x640")
    if any(launches[k] == 0 for k in MAIN_PATH):
        raise RuntimeError(f"a scorer kernel was not launched through the CLI: {launches}")
    _check_scoring(launches, calls[0])
    if not all(dense_equal.values()):
        raise RuntimeError(f"the saved dense scene reads back differently: {dense_equal}")
    for k in ("points", "raw_faces", "clean_faces"):
        if abs(got[k] - JAX_CLI[k]) > 0.05 * JAX_CLI[k]:
            raise RuntimeError(f"{k} {got[k]}: not within 5% of the JAX CLI's {JAX_CLI[k]}")
    for k in ("cloud", "clean", "refined"):
        if not got[f"{k}_height_error"] <= 1.05 * JAX_CLI[f"{k}_height_error"]:
            raise RuntimeError(f"{k} height error {got[f'{k}_height_error']} above 1.05x the "
                               f"JAX CLI's {JAX_CLI[f'{k}_height_error']}")
        if not got[f"{k}_within"] >= 0.98 * JAX_CLI[f"{k}_within"]:
            raise RuntimeError(f"{k} share within {HEIGHT_TOL} {got[f'{k}_within']} below "
                               f"0.98x the JAX CLI's {JAX_CLI[f'{k}_within']}")
    if not q_refined[0] <= q_clean[0]:
        raise RuntimeError(f"refinement raised the height error: {q_clean[0]} -> {q_refined[0]}")
    if not fidelity <= 1.02 * JAX_CLI["color_fidelity"]:
        raise RuntimeError(f"color fidelity {fidelity} above 1.02x the JAX CLI's "
                           f"{JAX_CLI['color_fidelity']}")
    if not within >= 0.98 * JAX_CLI["faces_within"]:
        raise RuntimeError(f"{within} of faces within {FIDELITY_BOUND} of a view's color, "
                           f"below 0.98x the JAX CLI's {JAX_CLI['faces_within']}")
    if not np.isfinite(np.asarray(refined.vertices)).all():
        raise RuntimeError("refine produced non-finite vertices")
    return {"error": q_cloud[0], "folder": folder, "points": len(pc)}


def phase_imports(card, files_error):
    """Real SfM input from files: the colored synthetic scene seen through
    a distorted OPENCV camera (synthetic.DISTORTION), written as an ETH3D
    training scene (5 JPEGs of 1280x960 at quality 95, a COLMAP text
    calibration, scan_clean/scan.ply); ``import-colmap`` as a command
    (undistorting the images), ``densify`` through
    ``openmvs_tpu_torch.__main__.main`` (launch counts set to 0 just before
    and read just after), ``eval --run --device cuda``, then
    ``_host_steps`` (``eval --est``, ``transform``, ``--split-max-points``)
    and, as a control, the same files imported as PINHOLE with the
    coefficients dropped and densified. Held to the JAX package's figures
    on the same files (JAX_IMPORTS)."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import __main__ as cli
    from openmvs_tpu_torch.interfaces.undistort import undistort_image
    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.io import ply as plyio
    from openmvs_tpu_torch.ops import pm_kernel
    from openmvs_tpu_torch.synthetic import DISTORTION, camera_intrinsics, write_eth3d_files

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene_dir, work = os.path.join(tmp, "eth3d"), os.path.join(tmp, "work")
        os.makedirs(work)
        t0 = time.perf_counter()
        digests, _ = write_eth3d_files(scene_dir, 5, 1280, 960)
        build_s = time.perf_counter() - t0
        for name, digest in sorted(digests.items()):
            print(f"sha256 {name} {digest}", flush=True)
        calib = os.path.join(scene_dir, "dslr_calibration_jpg")
        mvs = os.path.join(work, "scene.mvs")
        import_s, _, _ = _cli(["import-colmap", calib, "-i", scene_dir, "-o", mvs])
        und_dir = os.path.join(calib, "undistorted")
        undistorted = {n: _sha256(os.path.join(und_dir, n)) for n in sorted(os.listdir(und_dir))}
        # the layer's own seconds for one image: decode, map and remap, encode
        src = os.path.join(scene_dir, "images", "dslr_images", "view0000.jpg")
        t0 = time.perf_counter()
        img = imio.imread(src)
        t1 = time.perf_counter()
        und = undistort_image(img, camera_intrinsics(1280, 960), DISTORTION)
        t2 = time.perf_counter()
        imio.imwrite(os.path.join(work, "view0000.jpg"), und)
        undistort_one = {"imread": t1 - t0, "undistort_image": t2 - t1,
                         "imwrite": time.perf_counter() - t2}
        for name, digest in undistorted.items():
            print(f"sha256 undistorted/{name} {digest}", flush=True)

        with _scoring_calls() as calls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pm_kernel.reset_launches()
            densify_s, _ = _quiet(cli.main, ["densify", mvs])
            torch.cuda.synchronize()
            launches = dict(pm_kernel.LAUNCHES)
        densify_peak = torch.cuda.max_memory_allocated()
        dense_mvs = os.path.join(work, "scene_dense.mvs")
        cloud = plyio.load(dense_mvs.replace(".mvs", ".ply")).vertices
        q_cloud = _mesh_height_quality(cloud)

        torch.cuda.reset_peak_memory_stats()
        pm_kernel.reset_launches()
        eval_s, _ = _quiet(cli.main, ["eval", "--dataset", "eth3d", "--scene", scene_dir, "--run",
                                      "--device", "cuda", "-o", os.path.join(work, "run.json")])
        torch.cuda.synchronize()
        eval_launches = dict(pm_kernel.LAUNCHES)
        eval_peak = torch.cuda.max_memory_allocated()
        run_f, run_res = _fscores(os.path.join(work, "run.json"))
        host, host_s = _host_steps(cli.main, scene_dir, dense_mvs, work)

        ctrl = os.path.join(work, "pinhole.mvs")
        t0 = time.perf_counter()
        _quiet(cli.main, ["import-colmap", os.path.join(scene_dir, "pinhole_calibration"),
                          "-i", scene_dir, "-o", ctrl])
        _quiet(cli.main, ["densify", ctrl])
        control_s = time.perf_counter() - t0
        ctrl_cloud = plyio.load(ctrl.replace(".mvs", "_dense.ply")).vertices
        q_ctrl = _mesh_height_quality(ctrl_cloud)
    got = {"points": len(cloud), "cloud_height_error": q_cloud[0], "cloud_within": q_cloud[1],
           "run_fscores": run_f, **host}
    rec = {"phase": "imports", "views": 5, "image_W": 1280, "image_H": 960,
           "distortion": list(DISTORTION), "jpeg_sha256": digests,
           "undistorted_sha256": undistorted, "seconds": {
               "scene_build": build_s, "import_undistort": import_s, "densify": densify_s,
               "eval_run": eval_s, **host_s, "control": control_s,
               "transform": sum(v for k, v in host_s.items() if k.startswith("transform")),
               "one_image": undistort_one},
           "densify_launches": launches, "score_hypotheses_calls": calls[0],
           "eval_run_launches": eval_launches, "eval_run_points": run_res["n_est_points"],
           "gt_points": run_res["n_gt_points"],
           "max_memory_allocated_bytes": {"densify": densify_peak, "eval_run": eval_peak},
           "control_height_error": {"undistorted": q_cloud[0], "pinhole_ignoring_distortion":
                                    q_ctrl[0], "phase_files_pinhole": files_error},
           "control_within": {"undistorted": q_cloud[1], "pinhole_ignoring_distortion": q_ctrl[1]},
           "control_points": {"undistorted": len(cloud), "pinhole_ignoring_distortion":
                              len(ctrl_cloud)},
           "results": got, "jax": JAX_IMPORTS, "phase_s": time.perf_counter() - t_phase,
           "card": card}
    emit(rec)
    if digests != JAX_IMPORTS["jpeg_sha256"]:
        raise RuntimeError("the distorted JPEGs differ from the JAX run's: "
                           f"{digests} against {JAX_IMPORTS['jpeg_sha256']}")
    if undistorted != JAX_IMPORTS["undistorted_sha256"]:
        raise RuntimeError("the undistorted images differ from the JAX run's (cv2.undistort "
                           f"and cv2.imwrite): {undistorted}")
    for name, got_l in (("densify", launches), ("eval --run", eval_launches)):
        if any(got_l[k] == 0 for k in MAIN_PATH):
            raise RuntimeError(f"a scorer kernel was not launched by {name}: {got_l}")
    _check_scoring(launches, calls[0])
    if abs(got["points"] - JAX_IMPORTS["points"]) > 0.05 * JAX_IMPORTS["points"]:
        raise RuntimeError(f"{got['points']} dense points: not within 5% of the JAX "
                           f"run's {JAX_IMPORTS['points']}")
    if not got["cloud_height_error"] <= 1.05 * JAX_IMPORTS["cloud_height_error"]:
        raise RuntimeError(f"cloud height error {got['cloud_height_error']} above 1.05x "
                           f"the JAX run's {JAX_IMPORTS['cloud_height_error']}")
    if not got["cloud_within"] >= 0.98 * JAX_IMPORTS["cloud_within"]:
        raise RuntimeError(f"cloud share within {HEIGHT_TOL} {got['cloud_within']} below "
                           f"0.98x the JAX run's {JAX_IMPORTS['cloud_within']}")
    for key in ("run_fscores", "est_fscores"):
        for tol, f in got[key].items():
            if not abs(f - JAX_IMPORTS[key][tol]) <= 0.01:
                raise RuntimeError(f"{key} at {tol}: {f} not within 0.01 of the JAX run's "
                                   f"{JAX_IMPORTS[key][tol]}")
    if not (got["align_matrix_error"] <= 1e-6 and got["align_centre_error"] <= 1e-6):
        raise RuntimeError(f"the align round trip missed: matrix {got['align_matrix_error']}, "
                           f"centres {got['align_centre_error']}")
    if got["scaled"] != JAX_IMPORTS["scaled"] or got["scaled_sizes"] != [(640, 480)]:
        raise RuntimeError(f"the rescaled images differ from the JAX run's: {got['scaled']} "
                           f"{got['scaled_sizes']}")
    if not abs(got["volume"] - JAX_IMPORTS["volume"]) <= 1e-6 * abs(JAX_IMPORTS["volume"]):
        raise RuntimeError(f"volume {got['volume']} not within 1e-6 of the JAX run's "
                           f"{JAX_IMPORTS['volume']}")
    jc = JAX_IMPORTS["chunks"]
    if (len(got["chunks"]) != len(jc)
            or any(a["views"] != b["views"] for a, b in zip(got["chunks"], jc))
            or any(abs(a["points"] - b["points"]) > 0.05 * b["points"]
                   for a, b in zip(got["chunks"], jc))):
        raise RuntimeError(f"chunks {got['chunks']} against the JAX run's {jc}")
    if not q_cloud[0] < q_ctrl[0]:
        raise RuntimeError(f"undistortion did not lower the cloud's height error: {q_cloud[0]} "
                           f"against {q_ctrl[0]} imported as PINHOLE")


def _zstd_loads():
    """Whether the system libzstd loads for the project archives' BINARY_ZSTD
    type (io/boost_archive._zstd)."""
    from openmvs_tpu_torch.io import boost_archive

    try:
        boost_archive._zstd()
        return True
    except boost_archive.UnsupportedArchive:
        return False


def _scenes_equal(a, b):
    """Project archive read back against the .mvs load: cameras (K through
    the archive's normalised form, to float rounding), sizes and paths, the
    cloud and the mesh exactly."""
    import numpy as np

    if len(a.images) != len(b.images):
        return False
    for x, y in zip(a.images, b.images):
        if ((x.width, x.height) != (y.width, y.height)
                or os.path.abspath(x.path) != os.path.abspath(y.path)
                or not np.allclose(x.camera.K, y.camera.K, rtol=1e-5, atol=1e-4)
                or not np.allclose(x.camera.R, y.camera.R, rtol=0, atol=1e-12)
                or not np.allclose(x.camera.C, y.camera.C, rtol=0, atol=1e-12)):
            return False
    return (np.array_equal(a.pointcloud.points, b.pointcloud.points)
            and all(np.array_equal(u, v) for u, v in zip(a.pointcloud.views, b.pointcloud.views))
            and np.array_equal(a.mesh.vertices, b.mesh.vertices)
            and np.array_equal(a.mesh.faces, b.mesh.faces))


def phase_project(card, files):
    """The reference's boost "MVS project" archives on phase files' folder:
    scene.mvs with the mesh of its mesh command saved by Scene.save_project
    in the four archive types and read back (each equal to the .mvs load;
    seconds and bytes), the C++ emitter's golden archive read and written
    back byte for byte, then ``python -m openmvs_tpu_torch densify`` (its
    main, in this process) on the zstd project on the card, counts set to 0
    just before and read just after: points within 1% of phase files'."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import __main__ as cli
    from openmvs_tpu_torch import native
    from openmvs_tpu_torch.io import boost_archive as bar
    from openmvs_tpu_torch.io import ply as plyio
    from openmvs_tpu_torch.ops import pm_kernel
    from openmvs_tpu_torch.scene import Mesh, Scene

    t_phase = time.perf_counter()
    folder = files["folder"]
    zstd = _zstd_loads()
    ref = Scene.load(os.path.join(folder, "scene.mvs"))
    mp = plyio.load(os.path.join(folder, "mesh.ply"))
    ref.mesh = Mesh(vertices=mp.vertices.astype(np.float32), faces=mp.faces.astype(np.int32))
    types = ["text", "binary", "zip"] + (["zstd"] if zstd else [])
    io_rec = {}
    for atype in types:
        path = os.path.join(folder, f"project_{atype}.mvs")
        t0 = time.perf_counter()
        ref.save_project(path, archive_type=atype)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Scene.load(path)
        read_s = time.perf_counter() - t0
        io_rec[atype] = {"write_s": write_s, "read_s": read_s,
                         "bytes": os.path.getsize(path), "equal": _scenes_equal(back, ref)}
    golden = os.path.join(folder, "golden.mvs")
    native.emit_test_project(golden)
    rewritten = os.path.join(folder, "golden_rewritten.mvs")
    bar.save_project(bar.load_project(golden), rewritten, archive_type="binary")
    with open(golden, "rb") as f, open(rewritten, "rb") as g:
        golden_equal = f.read() == g.read()

    project = os.path.join(folder, f"project_{types[-1]}.mvs")
    dmaps = os.path.join(folder, "project_dmaps")
    with _scoring_calls() as calls:
        torch.cuda.synchronize()
        pm_kernel.reset_launches()
        t0 = time.perf_counter()
        _quiet(cli.main, ["densify", project, "--dmaps-folder", dmaps,
                          "-o", os.path.join(folder, "project_dense.mvs")])
        torch.cuda.synchronize()
        densify_s = time.perf_counter() - t0
        launches = dict(pm_kernel.LAUNCHES)
    points = len(Scene.load(os.path.join(folder, "project_dense.mvs")).pointcloud)
    rec = {"phase": "project", "zstd": "loads" if zstd else "absent",
           "mesh_faces": len(ref.mesh.faces), "archives": io_rec,
           "golden_rewritten_equal": golden_equal, "densify_archive": types[-1],
           "densify_s": densify_s, "launches": launches,
           "score_hypotheses_calls": calls[0], "points": points,
           "files_points": files["points"], "phase_s": time.perf_counter() - t_phase,
           "card": card}
    emit(rec)
    if not all(r["equal"] for r in io_rec.values()):
        raise RuntimeError(f"a project archive reads back differently: {io_rec}")
    if not golden_equal:
        raise RuntimeError("the port's writer does not repeat the C++ emitter's bytes")
    if any(launches[k] == 0 for k in MAIN_PATH):
        raise RuntimeError(f"a scorer kernel was not launched from the project: {launches}")
    _check_scoring(launches, calls[0])
    if abs(points - files["points"]) > 0.01 * files["points"]:
        raise RuntimeError(f"{points} points from the project, not within 1% of phase "
                           f"files' {files['points']}")
    return os.path.join(dmaps, "depth0000.dmap")


def _bound_views_banded(C, H, W, T, V, img_px, dm_px, mode, geom, rows_on):
    """The multi-view scorer's bound with band flags: the work of
    ``_bound_views`` for the ``rows_on`` active rows, and for the skipped
    pixels what their sentinel needs (bonus and delta read and the output
    written a (c, p), f_blend and d0 a pixel; V finish_view folds a
    (c, p)), plus the flags."""
    nbytes, flops = _views_work(C, rows_on, W, T, V, img_px, dm_px, mode, geom)
    off = (H - rows_on) * W
    nbytes += 4 * (3 * C * off + 2 * off) + -(-H // 16)
    flops += C * off * V * FLOP_FINISH
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the flagged multi-view scorer: (counter, sampling mode, geometric mode)
BAND_KERNELS = (("score_views_act_exact", "exact", "none"),
                ("score_views_act_nn", "nn", "none"),
                ("score_views_geom_act_exact", "exact", "geom"))


def _band_kernel_rows(card, scene, gts):
    """The flagged K1-mv (exact, nn) and K2-mv at the main path's operands
    (C=11, 480x640, V=4) against score_views_plain with the same flags, bit
    for bit, with half of the 30 bands flagged off and with all on (then
    also equal to the unflagged kernel); CUDA-graph ms of both and of the
    unflagged kernel, in this call. With every band off and the images and
    weights all NaN, the output is the sentinel: no image value or texel
    weight reached it."""
    import torch

    from openmvs_tpu_torch.ops import patchmatch, pm_kernel

    dev = torch.device("cuda")
    C = 11
    data, opts, depth, normal, _ = _kernel_inputs(C, dev, scene, gts)
    v = data.views
    V = v.image.shape[0]
    H, W = depth.shape[1:]
    T = data.goff.shape[0]
    th = float(opts.th_robust)
    wg = float(opts.estimation_geometric_weight)
    state = patchmatch.PMState(depth=depth[C // 2], normal=normal[0],
                               conf=torch.zeros_like(depth[0]))
    inv_nd, bonus, f_blend, delta = patchmatch.score_prelude(data, opts, state, depth, normal)
    args = (v.image, v.size, v.Hl, v.Hm, depth, normal, inv_nd, data.X0, data.goff,
            data.w, data.wtm, data.sum_w, data.norm_sq0, bonus, f_blend, delta,
            data.lowres)
    nb = -(-H // pm_kernel.BAND_ROWS)
    half = (torch.arange(nb, device=dev) % 2 == 0).contiguous()
    all_on = torch.ones(nb, dtype=torch.bool, device=dev)
    all_off = torch.zeros(nb, dtype=torch.bool, device=dev)
    rows = {}
    for name, mode, geom in BAND_KERNELS:
        kw = dict(th_robust=th, geom_weight=wg, nearest=mode == "nn")
        if geom == "geom":
            kw.update(Tr=v.Tr, Tn=v.Tn, dms=v.depth, uv=data.uv)
        rec = {"phase": "switches", "kernel": name, "C": C, "V": V, "H": H, "W": W,
               "T": T, "bands": nb, "bands_off_in_half": int((~half).sum())}
        err = 0.0
        for label, flags in (("half", half), ("all_on", all_on)):
            out_k = pm_kernel.score_views(*args, band_act=flags, **kw)
            torch.cuda.synchronize()
            out_p = pm_kernel.score_views_plain(*args, band_act=flags, **kw)
            torch.cuda.synchronize()
            both_nan = torch.isnan(out_k) & torch.isnan(out_p)
            err = max(err, float(torch.where(both_nan, 0.0, (out_k - out_p).abs()).max()))
            torch.testing.assert_close(out_k, out_p, rtol=0, atol=0, equal_nan=True)
            rec[f"equal_to_plain_{label}"] = True
            rec[f"ms_{label}"] = cuda_ms(lambda f=flags: pm_kernel.score_views(
                *args, band_act=f, **kw), 20, graph=True)
        unflagged = pm_kernel.score_views(*args, **kw)
        torch.testing.assert_close(out_k, unflagged, rtol=0, atol=0, equal_nan=True)
        rec["all_on_equal_to_unflagged"] = True
        rec["ms_unflagged"] = cuda_ms(lambda: pm_kernel.score_views(*args, **kw), 20,
                                      graph=True)
        rec["eager_ms_half"] = cuda_ms(lambda: pm_kernel.score_views(
            *args, band_act=half, **kw), 20)
        rec["plain_ms"] = cuda_ms(lambda: pm_kernel.score_views_plain(
            *args, band_act=half, **kw), 3)
        nan_args = list(args)
        nan_args[0] = torch.full_like(v.image, float("nan"))
        nan_args[9] = torch.full_like(data.w, float("nan"))
        nan_args[10] = torch.full_like(data.wtm, float("nan"))
        nkw = dict(kw, dms=torch.full_like(v.depth, float("nan"))) if geom == "geom" else kw
        off_k = pm_kernel.score_views(*nan_args, band_act=all_off, **nkw)
        off_p = pm_kernel.score_views_plain(*args, band_act=all_off, **kw)
        torch.testing.assert_close(off_k, off_p, rtol=0, atol=0, equal_nan=True)
        rec["all_off_reads_no_image"] = True
        rows_on = int(pm_kernel.band_rows(half, H).sum())
        rec["bound_ms_half"], rec["bound_by_half"] = _bound_views_banded(
            C, H, W, T, V, v.image[0].numel(), v.depth[0].numel(), mode, geom, rows_on)
        rec["bound_ms_all_on"], rec["bound_by_all_on"] = _bound_views(
            C, H, W, T, V, v.image[0].numel(), v.depth[0].numel(), mode, geom)
        rec["max_abs_err"] = err
        rec["card"] = card
        emit(rec)
        rows[(name, C)] = dict(rec, ms=rec["ms_half"], bound_ms=rec["bound_ms_half"],
                               bound_by=rec["bound_by_half"])
    return rows


def _band_counts():
    """patchmatch.BANDS as ints (its skipped count is a device sum) and the
    skipped share."""
    from openmvs_tpu_torch.ops import patchmatch

    counts = {k: int(v) for k, v in patchmatch.BANDS.items()}
    return counts, counts["skipped"] / max(counts["scored"], 1)


def _skipping_sweeps(scene, gts, eps):
    """Three geometric exact sweeps of view 2 at 480x640 through
    patchmatch.sweep, with conf_prev threaded as densify threads it and
    ``eps`` from the third sweep on: the flagged K2-mv. No densify schedule
    reaches it, in the port or the JAX package: a geometric pass is one
    sweep, and skipping starts at the sweep OMVS_ACTIVE_FROM (default 2)
    with the previous sweep's confidence. Counts set to 0 just before, read
    just after; (launches, skipped share)."""
    import torch

    from openmvs_tpu_torch.ops import patchmatch, pm_kernel

    dev = torch.device("cuda")
    data, opts, depth, normal, _ = _kernel_inputs(1, dev, scene, gts)
    V = data.views.image.shape[0]
    patchmatch.BANDS.update(scored=0, skipped=0)
    pm_kernel.reset_launches()
    state = patchmatch.init_state(data, opts, (0, 7), depth[0], normal[0], V, True,
                                  mode="exact")
    prev = None
    for it in range(3):
        this = state.conf
        state = patchmatch.sweep(state, data, opts, (0, 7), V, True, mode="exact",
                                 fold=it + 1, active_eps=eps if it >= 2 else 0.0,
                                 conf_prev=prev)
        prev = this
    torch.cuda.synchronize()
    return dict(pm_kernel.LAUNCHES), _band_counts()[1]


def _warp_card_vs_cpu():
    """Two warp sweeps of view 0 of the 120x160 scene on the card and on the
    CPU, from the same init: (mask agreement, depth agreement to 1e-3)."""
    import numpy as np

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import patchmatch
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, gts, _ = build_gt_scene(n_views=3, W=160, H=120)
    opts = DenseOptions()
    cams = [im.working_camera() for im in scene.images]
    out = {}
    for dev in ("cuda", "cpu"):
        data = densify._build_pm_data(scene.images[0].gray, cams[0],
                                      [im.gray for im in scene.images[1:]], cams[1:],
                                      opts, 4.5, 7.5, None, None, device=dev)
        seed = np.where(gts[0] > 0, gts[0] * 1.02, 6.0).astype(np.float32)
        sn = np.tile(np.array([0, 0, -1], np.float32), seed.shape + (1,))
        state = patchmatch.init_state(data, opts, (0, 3), seed, sn, 2, False, mode="exact")
        for it in range(2):
            state = patchmatch.sweep(state, data, opts, (0, 3), 2, False, mode="warp",
                                     fold=it + 1)
        out[dev] = state.depth.cpu().numpy()
    a, b = out["cuda"], out["cpu"]
    va, vb = a > 0, b > 0
    both = va & vb
    return (float((va == vb).mean()),
            float((np.abs(a - b)[both] < 1e-3 * b[both]).mean()) if both.any() else 1.0)


def _switch_card_vs_cpu(env):
    """View 0's photometric estimate_depth_map of the 120x160 scene
    (DenseOptions()) under ``env`` on the card and on the CPU: mask and
    depth agreement, and the seconds of each (a whole densify on this
    host's CPU takes over a minute at this size)."""
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    scene, _, _ = build_gt_scene(n_views=3, W=160, H=120)
    select_views_for_scene(scene, DenseOptions())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    maps, secs = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            maps[dev] = densify.estimate_depth_map(scene, 0, DenseOptions(), device=dev).depth
            secs[dev] = time.perf_counter() - t0
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
    m, d, _ = _agreement([maps["cuda"]], [maps["cpu"]])
    return {"mask_agreement": m[0], "depth_agreement": d[0], "cuda_s": secs["cuda"],
            "cpu_s": secs["cpu"]}


def phase_switches(card, scene, gts, textured, dmap_path):
    """densify's remaining modes and switches on the card: the flagged
    scorer against its plain version (_band_kernel_rows); a full densify
    under OMVS_ACTIVE=5e-3 with OMVS_EARLY_EXIT=0 (so that nn search sweeps
    run one by one and may skip; with the early-exit block, the default,
    no sweep is eligible) against the same run without OMVS_ACTIVE, both
    with counts set to 0 just before and read just after: seconds, the
    share of band half-sweeps skipped, launches, points, quality held to
    phase densify's 95%-of-JAX bounds; the same under OMVS_ALL_EXACT=1
    OMVS_ACTIVE=5e-3 (no mode switch, so exact sweeps skip: the flagged
    exact K1-mv); the flagged K2-mv through patchmatch.sweep, which no
    densify schedule reaches (_skipping_sweeps); at 120x160 the card against the CPU
    (two warp sweeps, and one view's estimate under OMVS_ALL_EXACT and
    under OMVS_EARLY_EXIT=0) held to phase parity's agreement,
    OMVS_PROFILE_DIR writing a trace; dump -o of a
    .dmap; render_mesh and export_html of phase pipeline's textured
    mesh."""
    import numpy as np

    from openmvs_tpu_torch import __main__ as cli
    from openmvs_tpu_torch import densify, viewer, viewer_web
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import patchmatch
    from openmvs_tpu_torch.synthetic import build_gt_scene, depth_quality

    t_phase = time.perf_counter()
    rows = _band_kernel_rows(card, scene, gts)
    n = len(scene.images)
    runs = {}
    for label, env in (("early_exit_0", {"OMVS_EARLY_EXIT": "0"}),
                       ("active", {"OMVS_EARLY_EXIT": "0", "OMVS_ACTIVE": "5e-3"}),
                       ("all_exact_active", {"OMVS_ALL_EXACT": "1", "OMVS_ACTIVE": "5e-3"})):
        patchmatch.BANDS.update(scored=0, skipped=0)
        pc, maps, wall, launches, stages, calls, _ = _run_densify(scene, env=env)
        q = [depth_quality(maps[i], gts[i]) for i in range(n)]
        counts, share = _band_counts()
        runs[label] = {"env": env, "wall_s": wall, "stages_s": stages, "points": len(pc),
                       "launches": launches, "score_hypotheses_calls": calls,
                       "band_half_sweeps": counts, "skipped_share": share,
                       "accuracy": [a for a, _ in q], "completeness": [c for _, c in q]}
        _check_scoring(launches, calls)
        _check_quality(q)
    sweep_launches, sweep_skipped = _skipping_sweeps(scene, gts, 5e-3)

    small = {label: _switch_card_vs_cpu(env) for label, env in (
        ("all_exact", {"OMVS_ALL_EXACT": "1"}), ("early_exit_0", {"OMVS_EARLY_EXIT": "0"}))}
    small["warp"] = dict(zip(("mask_agreement", "depth_agreement"), _warp_card_vs_cpu()))
    with tempfile.TemporaryDirectory() as tmp:
        # a one-sweep, one-level schedule keeps the trace to a few thousand
        # launches
        s, _, _ = build_gt_scene(n_views=2, W=160, H=120)
        os.environ["OMVS_PROFILE_DIR"] = tmp
        try:
            densify.dense_reconstruction(s, DenseOptions(
                sub_resolution_levels=0, estimation_iters=1, estimation_geometric_iters=0),
                device="cuda")
        finally:
            os.environ.pop("OMVS_PROFILE_DIR")
        trace = os.path.join(tmp, "densify.json")
        trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace) as f:
            trace_events = len(json.load(f).get("traceEvents", []))
        dump_dir = os.path.join(tmp, "dump")
        _quiet(cli.main, ["dump", dmap_path, "-o", dump_dir])
        pngs = sorted(os.listdir(dump_dir))
        t0 = time.perf_counter()
        frame = viewer.render_mesh(textured)
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        page = viewer_web.export_html(s, os.path.join(tmp, "view.html"))
        with open(page) as f:
            html = f.read()
        export_s = time.perf_counter() - t0
        s.mesh = textured
        textured_page = viewer_web.export_html(s, os.path.join(tmp, "textured.html"))
        textured_bytes = os.path.getsize(textured_page)
        with open(textured_page) as f:
            has_atlas = '"tex_png"' in f.read()
    hit_share = float((frame != np.array([24, 24, 28], np.uint8)).any(-1).mean())
    rec = {"phase": "switches", "H": 480, "W": 640, "densify": runs,
           "skipping_sweeps": {"launches": sweep_launches, "skipped_share": sweep_skipped},
           "card_vs_cpu_120x160": small,
           "profile_trace": {"bytes": trace_bytes, "events": trace_events},
           "dump_pngs": pngs,
           "render_mesh": {"shape": list(frame.shape), "covered_share": hit_share,
                           "s": render_s, "faces": len(textured.faces)},
           "export_html": {"bytes": len(html), "s": export_s,
                           "textured_bytes": textured_bytes, "atlas": has_atlas},
           "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(rec)
    for label, key in (("active", "score_views_act_nn"),
                       ("all_exact_active", "score_views_act_exact")):
        if runs[label]["launches"][key] == 0:
            raise RuntimeError(f"{label}: no {key} launch: {runs[label]['launches']}")
    if sweep_launches["score_views_geom_act_exact"] == 0:
        raise RuntimeError(f"the flagged geometric scorer was not launched: {sweep_launches}")
    for label, r in small.items():
        if r["mask_agreement"] <= 0.99 or r["depth_agreement"] <= 0.99:
            raise RuntimeError(f"{label}: card and CPU disagree: {r}")
    if trace_events == 0:
        raise RuntimeError("OMVS_PROFILE_DIR wrote no trace events")
    if pngs != ["conf0000.png", "depth0000.png", "normal0000.png"]:
        raise RuntimeError(f"dump -o wrote {pngs}")
    if not hit_share > 0.05 or not has_atlas or '"cam_lines"' not in html:
        raise RuntimeError("the viewers rendered nothing of the scene")
    return rows, runs["active"]["launches"], runs["all_exact_active"]["launches"], \
        sweep_launches


def _wall_s(fn):
    """(result, seconds) of ``fn()``, the card synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serial_chain(scene, opts, dev):
    """The serial port's photometric pass and geometric passes over every
    view under OMVS_EARLY_EXIT=0, the schedule the sharded path runs, its
    sweep graphs kept across the calls as dense_reconstruction keeps them:
    (list of {id: DepthMapResult} per pass, seconds per pass)."""
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.ops import graphs

    saved = os.environ.get("OMVS_EARLY_EXIT")
    os.environ["OMVS_EARLY_EXIT"] = "0"
    runners = graphs.Runners()
    passes, secs = [], []
    try:
        prev = None
        for gi in range(-1, opts.estimation_geometric_iters):
            def run():
                out = {}
                for i, im in enumerate(scene.images):
                    if prev is not None and im.meta.id not in prev:
                        continue
                    r = densify.estimate_depth_map(
                        scene, i, opts, prev=None if prev is None else prev[im.meta.id],
                        neighbor_results=prev, geometric_iter=gi, device=dev,
                        runners=runners)
                    if r is not None:
                        out[im.meta.id] = r
                return out
            res, s = _wall_s(run)
            if prev is not None:
                res = {**prev, **res}
            passes.append(res)
            secs.append(s)
            prev = res
    finally:
        if saved is None:
            os.environ.pop("OMVS_EARLY_EXIT", None)
        else:
            os.environ["OMVS_EARLY_EXIT"] = saved
    return passes, secs


def _map_agreement(got, want):
    """Per view: the share of pixels whose valid mask and depth are equal;
    mask agreement; depths within 1e-3 relative on pixels valid in both."""
    import numpy as np

    out = {}
    for rid, w in want.items():
        a, b = got[rid].depth, w.depth
        va, vb = a > 0, b > 0
        both = va & vb
        out[rid] = {"equal": float(((va == vb) & ((a == b) | ~vb)).mean()),
                    "mask": float((va == vb).mean()),
                    "depth_1e-3": float((np.abs(a - b)[both] < 1e-3 * b[both]).mean())
                    if both.any() else 1.0}
    return out


def _sgm_batch(P_n, H, W, num_d, d_min):
    """P_n rectified pairs of about constant disparity 5 (__graft_entry__.py's
    SGM stage at the given size): (lefts, rights shifted by d_min)."""
    import numpy as np

    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (P_n, H, W + 16)).astype(np.float32)
    lefts = np.ascontiguousarray(base[:, :, 16:])
    rights = np.roll(base, 5, axis=2)[:, :, 16:]
    shifted = np.zeros_like(rights)
    shifted[:, :, -d_min:] = rights[:, :, :W + d_min]
    return lefts, shifted


def _fusion_serial(X, Nw, nbs, opts):
    """__graft_entry__.py's numpy reference of the fusion reduction: each
    neighbour view's agreement and weighted evidence, float64, in turn."""
    import numpy as np

    from openmvs_tpu_torch.ops.fusion import conf2weight

    sX = np.zeros((len(X), 3))
    sW = np.zeros(len(X))
    sA = np.zeros(len(X), np.int64)
    cosn = np.cos(np.radians(opts.normal_diff_threshold))
    for n in nbs:
        hb, wb = n.depth.shape
        pb = n.camera.project_h(X)
        zb = pb[:, 2]
        front = zb > 0
        ix = np.round(np.where(front, pb[:, 0] / np.where(front, zb, 1), -1)).astype(int)
        iy = np.round(np.where(front, pb[:, 1] / np.where(front, zb, 1), -1)).astype(int)
        inside = front & (ix >= 0) & (ix < wb) & (iy >= 0) & (iy < hb)
        ixc, iyc = np.clip(ix, 0, wb - 1), np.clip(iy, 0, hb - 1)
        db = n.depth[iyc, ixc].astype(np.float64)
        similar = inside & (db > 0) & (np.abs(zb - db) < opts.depth_diff_threshold * zb)
        Nb = n.normal[iyc, ixc] @ n.camera.R
        agree = similar & (np.einsum("ij,ij->i", Nw, Nb) > cosn)
        w = np.where(agree, conf2weight(n.conf[iyc, ixc], db, opts.fuse_conf_weight_floor),
                     0.0)
        Xb = n.camera.unproject(np.stack([ixc, iyc], -1).astype(np.float64), db)
        sX += np.where(agree[:, None], Xb * w[:, None], 0.0)
        sW += w
        sA += agree
    return sX, sW, sA


def phase_multidevice(card, scene, colored, gts, dense, dense_maps, dense_s):
    """The multi-device paths on make_mesh(4) = (2, 2) shards of the one
    card: sharded estimation against the serial port, the sharded
    dense_reconstruction, the sharded filter against the host filter,
    dense_reconstruction with two view workers against phase densify's
    cloud ``dense``, maps ``dense_maps`` and seconds ``dense_s``, the
    label-sharded LBP, refine's pair axis over 2 shards, SGM pairs and the
    fusion reduction over 4."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import densify, refine, texture
    from openmvs_tpu_torch.config import DenseOptions, RefineOptions, TextureOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.ops import pm_kernel
    from openmvs_tpu_torch.parallel import sharded
    from openmvs_tpu_torch.parallel.sharded_filter import filter_views_sharded
    from openmvs_tpu_torch.synthetic import depth_quality, height_field_mesh
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = sharded.make_mesh(4)
    n = len(scene.images)
    opts = DenseOptions()
    select_views_for_scene(scene, opts)
    t_phase = time.perf_counter()

    # 1. sharded estimation against the serial port, pass by pass
    serial, serial_s = _serial_chain(scene, opts, dev)
    pm_kernel.reset_launches()
    sh_passes, sh_s = [], []
    prev = None
    for gi in range(-1, opts.estimation_geometric_iters):
        res, s = _wall_s(lambda: sharded.estimate_views_sharded(
            scene, opts, mesh, prev_results=prev, geometric_iter=gi))
        if prev is not None:
            res = {**prev, **res}
        sh_passes.append(res)
        sh_s.append(s)
        prev = res
    launches = {k: v for k, v in pm_kernel.LAUNCHES.items() if v}
    agree = [_map_agreement(a, b) for a, b in zip(sh_passes, serial)]
    estimate = {"mesh": list(mesh.shape), "passes": ["photometric"] + [
                    f"geometric {g}" for g in range(opts.estimation_geometric_iters)],
                "sharded_s": sh_s, "serial_s": serial_s,
                "sharded_over_serial": sum(sh_s) / sum(serial_s),
                "equal_share": [[v["equal"] for v in a.values()] for a in agree],
                "mask_agreement": [[v["mask"] for v in a.values()] for a in agree],
                "launches": launches}
    emit({"phase": "multidevice", "check": "estimate_views_sharded", **estimate,
          "card": card})
    worst = min(min(x) for x in estimate["equal_share"])
    if worst < 0.999:
        raise RuntimeError(f"sharded maps equal the serial ones on only {worst} of a view")
    n_tile = mesh.shape[1]
    k2 = launches.get("score_views_geom_exact", 0)
    if not all(launches.get(k) for k in MAIN_PATH):
        raise RuntimeError(f"a scorer kernel was not launched on the sharded path: "
                           f"{launches}")
    if k2 != 3 * n_tile * n * opts.estimation_geometric_iters:
        raise RuntimeError(f"K2-mv launches {k2}: expected 3 per tile block, view "
                           "and geometric pass")

    # 2. dense_reconstruction on the mesh
    with tempfile.TemporaryDirectory() as tmp:
        pm_kernel.reset_launches()
        pc, wall = _wall_s(lambda: densify.dense_reconstruction(
            scene, opts, save_dmaps_to=tmp, device=dev, mesh=mesh))
        maps = _dmaps(tmp, n)
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    rec = {"check": "dense_reconstruction", "wall_s": wall, "points": len(pc),
           "phase_densify_points": len(dense),
           "points_ratio": len(pc) / len(dense),
           "accuracy": [a for a, _ in q], "completeness": [c for _, c in q],
           "launches": {k: v for k, v in pm_kernel.LAUNCHES.items() if v}}
    emit({"phase": "multidevice", **rec, "card": card})
    if abs(len(pc) - len(dense)) > 0.01 * len(dense):
        raise RuntimeError(f"sharded densify: {len(pc)} points, phase densify {len(dense)}")
    _check_quality(q)

    # 3. the sharded filter against the host filter (the JAX package's bar,
    # __graft_entry__.py:161-165) and against itself on the CPU (which the
    # tests hold to the JAX package's bit for bit), on the same maps. Its
    # float32 projection of these axis-aligned cameras puts an integer
    # source row just below the row about half the time (the host's float64
    # lands on it), which moves a depth by more than 1e-3 only where
    # neighbouring depths differ much: at 120x160 on 2-4% of pixels
    # (tests/_torch_filter_floor.py), at 640x480 on less than 1%.
    final = sh_passes[-1]
    f_sh, f_sh_s = _wall_s(lambda: filter_views_sharded(final, opts, mesh))
    t0 = time.perf_counter()
    f_host = densify._filter_views(final, set(), opts)
    f_host_s = time.perf_counter() - t0
    f_cpu = filter_views_sharded(final, opts, sharded.make_mesh(4, devices=["cpu"] * 4))
    fa = _map_agreement(f_sh, f_host)
    cpu_eq = [float(((f_sh[k].depth == f_cpu[k].depth) & (f_sh[k].conf == f_cpu[k].conf)).mean())
              for k in f_cpu]
    emit({"phase": "multidevice", "check": "filter_views_sharded", "sharded_s": f_sh_s,
          "host_s": f_host_s, "mask_agreement": [v["mask"] for v in fa.values()],
          "depth_1e-3": [v["depth_1e-3"] for v in fa.values()],
          "equal_to_cpu_sharded": cpu_eq, "card": card})
    worst = min(min(v["mask"], v["depth_1e-3"]) for v in fa.values())
    if worst <= 0.99 or min(cpu_eq) < 0.999:
        raise RuntimeError(f"sharded filter: against the host filter {fa}, equal to "
                           f"the CPU's on {cpu_eq}")

    # 4. dense_reconstruction with two view workers sharing the card (one
    # thread and stream each, _run_views_parallel) against phase densify's
    with tempfile.TemporaryDirectory() as tmp:
        pc2, two_s = _wall_s(lambda: densify.dense_reconstruction(
            scene, opts, save_dmaps_to=tmp, device=dev, devices=[dev, dev]))
        maps2 = _dmaps(tmp, n)
    same_maps = [bool(np.array_equal(a, b)) for a, b in zip(maps2, dense_maps)]
    same_points = bool(np.array_equal(pc2.points, dense.points))
    emit({"phase": "multidevice", "check": "dense_reconstruction(devices=2)",
          "one_device_s": dense_s, "two_workers_s": two_s, "ratio": two_s / dense_s,
          "points": len(pc2), "maps_bit_equal": same_maps, "points_bit_equal": same_points,
          "card": card})
    if not (all(same_maps) and same_points):
        raise RuntimeError("two view workers gave other maps or points than phase densify")

    # 5. label-sharded LBP on phase texture's qualities
    topts = TextureOptions()
    tmesh = height_field_mesh(320)
    max_dim = imio.compute_max_resolution(
        max(im.width for im in colored.images), max(im.height for im in colored.images),
        topts.resolution_level, topts.min_resolution, 1 << 30)
    qual, fc = texture.compute_face_qualities(colored, tmesh, max_dim)
    qual = texture.remove_outlier_views(qual, fc, topts.outlier_threshold)
    adj = texture._face_adjacency(tmesh.faces)
    lam = topts.ratio_data_smoothness * 10
    lab1 = texture.label_faces_lbp(qual, adj, lam, device=dev)
    lab4 = texture.label_faces_lbp_sharded(qual, adj, lam, mesh.flat())
    lbp_s = cuda_ms(lambda: texture.label_faces_lbp(qual, adj, lam, device=dev), 3) / 1e3
    lbp4_s = cuda_ms(lambda: texture.label_faces_lbp_sharded(
        qual, adj, lam, mesh.flat()), 3) / 1e3
    lbp_eq = float((lab1 == lab4).mean())
    emit({"phase": "multidevice", "check": "label_faces_lbp_sharded", "faces": len(qual),
          "shards": mesh.size, "ms": lbp4_s * 1e3, "serial_ms": lbp_s * 1e3,
          "equal_share": lbp_eq, "card": card})
    if lbp_eq < 0.999:
        raise RuntimeError(f"sharded LBP labels equal the serial ones on {lbp_eq}")

    # 6. refine's pair axis over 2 shards
    gt, v0 = _noisy_grid(150, 11)
    fs = _FullScale(scene, v0, gt.faces)
    pds, mt, scal, _ = fs.on(dev)
    e1, g1 = refine._energy_grad(mt.verts, pds, mt.adj, mt.deg, mt.faces, *scal[:3],
                                 mt.boundary, scal[3])
    npd = refine.PairData(**{k: getattr(pds, k).cpu().numpy() for k in pds._fields})
    shards = refine.shard_pairs(npd, mt.faces, [dev, dev])
    e2, g2 = refine._energy_grad(mt.verts, shards, mt.adj, mt.deg, mt.faces, *scal[:3],
                                 mt.boundary, scal[3])
    g1, g2 = g1.cpu().numpy(), g2.cpu().numpy()
    e_rel = abs(float(e2) - float(e1)) / max(abs(float(e1)), 1.0)
    g_fail = int((np.abs(g2 - g1) > 1e-4 * np.abs(g1) + 1e-6).sum())
    out1, r1_s = _wall_s(lambda: refine.refine_mesh(
        scene, mesh_from_numpy(v0, gt.faces), RefineOptions(), device=dev))
    out2, r2_s = _wall_s(lambda: refine.refine_mesh(
        scene, mesh_from_numpy(v0, gt.faces), RefineOptions(), device=dev,
        devices=[dev, dev]))
    err0, err1, err2 = (_height_error(v0), _height_error(out1.vertices),
                        _height_error(out2.vertices))
    emit({"phase": "multidevice", "check": "refine pairs over 2 shards",
          "faces": len(gt.faces), "pairs": len(fs.pairs), "energy_rel": e_rel,
          "grad_outside_rtol_1e-4_atol_1e-6": g_fail, "one_shard_s": r1_s,
          "two_shards_s": r2_s, "height_error": [err0, err1, err2], "card": card})
    if e_rel >= 1e-5 or g_fail:
        raise RuntimeError(f"sharded _energy_grad: energy rel {e_rel}, {g_fail} gradient "
                           "elements beyond rtol 1e-4 / atol 1e-6")
    if err2 > 1.05 * err1:
        raise RuntimeError(f"refine over 2 shards: height error {err2}, one shard {err1}")

    # 7. SGM pairs and the fusion reduction over the 4 shards
    from openmvs_tpu_torch.ops import sgm

    P_n, Hs, Ws, num_d, d_min = 5, 240, 320, 32, -12
    lefts, shifted = _sgm_batch(P_n, Hs, Ws, num_d, d_min)
    (disp, _), sgm_s = _wall_s(lambda: sharded.sgm_pairs_sharded(
        lefts, shifted, d_min, num_d, mesh.flat()))
    eq = []
    for p in range(P_n):
        left = torch.from_numpy(lefts[p:p + 1]).to(dev)
        vol = sgm._wzncc_volumes(left, torch.from_numpy(shifted[p:p + 1]).to(dev),
                                 [d_min], num_d)
        idx, _ = sgm._argmin_first(sgm.aggregate8(vol, left))
        eq.append(float((disp[p] == idx[0].cpu().numpy() + d_min).mean()))
    ref_id = max(final, key=lambda rid: len(final[rid].neighbor_ids))
    r = final[ref_id]
    yy, xx = np.nonzero(r.depth > 0)
    yy, xx = yy[:4000], xx[:4000]
    X = r.camera.unproject(np.stack([xx, yy], -1).astype(np.float64),
                           r.depth[yy, xx].astype(np.float64))
    Nw = r.normal[yy, xx].astype(np.float64) @ r.camera.R
    nbs = [final[j] for j in r.neighbor_ids if j in final]
    nb = dict(depth=np.stack([v.depth for v in nbs]), normal=np.stack([v.normal for v in nbs]),
              conf=np.stack([v.conf for v in nbs]), K=np.stack([v.camera.K for v in nbs]),
              R=np.stack([v.camera.R for v in nbs]), C=np.stack([v.camera.C for v in nbs]),
              valid=np.ones(len(nbs), np.float32))
    (accX, accW, nA), fus_s = _wall_s(lambda: sharded.fusion_reduce_sharded(
        X.astype(np.float32), Nw.astype(np.float32), nb, opts, mesh.flat()))
    sX, sW, sA = _fusion_serial(X, Nw, nbs, opts)
    both = (sW > 0) & (accW > 0)
    relw = float((np.abs(accW[both] - sW[both]) / np.maximum(sW[both], 1e-9) < 1e-3).mean())
    agree_eq = float((nA == sA).mean())
    emit({"phase": "multidevice", "check": "sgm_pairs and fusion_reduce sharded",
          "sgm_pairs": P_n, "sgm_hw_d": [Hs, Ws, num_d], "sgm_s": sgm_s,
          "sgm_equal_share": eq, "fusion_candidates": len(X), "fusion_views": len(nbs),
          "fusion_s": fus_s, "fusion_agree_equal": agree_eq,
          "fusion_weight_within_1e-3": relw, "phase_s": time.perf_counter() - t_phase,
          "card": card})
    if min(eq) < 0.999 or agree_eq < 0.999 or relw < 0.999:
        raise RuntimeError(f"sharded SGM pairs {eq} or fusion reduction "
                           f"({agree_eq}, {relw}) below 0.999")


def main():
    if not os.path.isdir(os.path.join(REPO, "openmvs_tpu_torch")):
        raise SystemExit("chip_smoke: openmvs_tpu_torch/ not found beside this script")
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("OMVS_GEOM_SPLIT", "OMVS_GEOM_FUSED", "OMVS_GEOM_DEBUG"):
        os.environ.pop(k, None)
    card = phase_device()
    phase_build()
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.synthetic import build_gt_scene

    t0 = time.perf_counter()
    colored, gts, arrays = build_gt_scene(n_views=5, W=640, H=480, color=True)
    t_scene = time.perf_counter() - t0
    # every phase but texture reads the gray images alone, as before
    # texturing came: with colors, densify's fusion would color its points
    scene = scene_from_arrays(**dict(arrays, colors=None))
    rows = phase_kernels(card, scene, gts)
    launches = {"variants": phase_variants(card)}
    launches["densify"], maps, dense, dense_s = phase_densify(card, scene, gts, t_scene)
    phase_multidevice(card, scene, colored, gts, dense, maps, dense_s)
    phase_profile(card, scene)
    launches["geom_split"] = phase_geom_split(card, scene, gts, maps,
                                              launches["densify"])
    phase_geom_unfused(card, phase_parity(card))
    rows["segment_sum"], launches["refine"] = phase_refine(card, scene)
    phase_texture(card, colored)
    sgm_rows, launches["sgm"] = phase_sgm(card, scene, gts)
    rows.update(sgm_rows)
    textured = phase_pipeline(card, scene, colored, dense)
    with tempfile.TemporaryDirectory() as folder:
        files = phase_files(card, folder)
        dmap = phase_project(card, files)
        (band_rows, launches["switches"], launches["switches_exact"],
         launches["sweeps"]) = phase_switches(card, scene, gts, textured, dmap)
        rows.update(band_rows)
    phase_imports(card, files["error"])
    kernels = []
    for name, source, replaces, path in KERNEL_LINE:
        r = rows[name] if name in rows else rows[(name, 11)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"openmvs_tpu_torch/csrc/{source}", "replaces": replaces,
            "path": path, "launches": launches[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
