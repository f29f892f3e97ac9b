"""Dense-reconstruction, meshing, mesh-refinement and texturing options (the
``DenseOptions``, ``MeshOptions``, ``RefineOptions`` and ``TextureOptions``
tables of the JAX package's ``openmvs_tpu/config.py``, copied so the port
never imports it).

Defaults reproduce the reference's OPTDENSE workspace
(libs/MVS/DepthMap.cpp:69-113, DensifyPointCloud.cpp:117-153) and its
Scene::ReconstructMesh, Scene::RefineMesh and Scene::TextureMesh arguments
(Scene.h:138-160).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class DenseOptions:
    """Depth-map estimation + fusion knobs (reference OPTDENSE workspace)."""

    # -- fusion --
    fuse_mode: str = "fuse"          # "fuse" (cross-view agreement) | "merge"
    # Conf2Weight saturation floor (reference constant 0.03,
    # SceneDensify.cpp:120) recalibrated to this estimator's deeper
    # convergence — see ops/fusion.conf2weight for the full derivation
    fuse_conf_weight_floor: float = 0.09

    # -- resolution policy (DepthMap.cpp:69-72) --
    resolution_level: int = 1        # scale down images this many times (halvings)
    max_resolution: int = 3200       # do not scale images above this resolution
    min_resolution: int = 640        # do not scale images below this resolution
    sub_resolution_levels: int = 2   # lower-res PatchMatch pyramid levels

    # -- view counts (DepthMap.cpp:73-79) --
    min_views: int = 2               # min agreeing views to validate a depth
    max_views: int = 12              # max neighbor views per reference image
    min_views_fuse: int = 2          # min agreeing images during fusion (app default 3)
    min_views_filter: int = 2        # min agreeing images during filtering
    min_views_filter_adjust: int = 1 # min agreeing images for adjusted filtering
    min_views_trust_point: int = 2   # min views for a sparse point to seed depth
    num_views: int = 0               # neighbor views used for estimation (0=all)
    point_inside_roi: int = 1        # 0 ignore ROI, 1 weight ROI, 2 only ROI

    # -- estimation behavior flags (DepthMap.cpp:80-86) --
    filter_adjust: bool = True       # adjust depth estimates during filtering
    add_corners: bool = False        # add synthetic support points at corners
    init_sparse: bool = True         # seed only with sparse points (no interpolation)
    remove_dmaps: bool = False       # delete .dmap artifacts after fusion

    # -- neighbor-view selection (DepthMap.cpp:87-92, Scene.cpp:801) --
    view_min_score: float = 2.0        # min absolute neighbor score
    view_min_score_ratio: float = 0.03 # min score relative to best neighbor
    min_area: float = 0.05             # min shared area
    min_angle: float = 3.0             # deg
    optim_angle: float = 12.0          # deg
    max_angle: float = 65.0            # deg

    # -- matching thresholds (DepthMap.cpp:93-99) --
    descriptor_min_magnitude: float = 0.02  # min patch stddev (texture test)
    depth_diff_threshold: float = 0.01      # relative depth agreement
    normal_diff_threshold: float = 25.0     # deg, normal agreement in fusion
    # NOTE: the reference's fPairwiseMul / fOptimizerEps / nOptimizerMaxIters
    # (DepthMap.cpp:94-96) tune the TRW-S solve of the nNumViews==1 pairing
    # MRF; the pairing here is solved EXACTLY as a max-weight matching
    # (view_selection.select_pairs_global), so those knobs have no role and
    # are intentionally not declared.

    # -- post-filters (DepthMap.cpp:100-102) --
    speckle_size: int = 100        # connected segments smaller than this removed
    ipol_gap_size: int = 7         # interpolate scanline gaps up to this length
    ignore_mask_label: int = -1    # segmentation label to mask out (<0 disabled)
    optimize: int = 7              # bitmask: 1 remove-speckles | 2 fill-gaps | 4 adjust-filter

    # -- outputs (DepthMap.cpp:104-105) --
    estimate_colors: int = 2
    estimate_normals: int = 2

    # -- PatchMatch core (DepthMap.cpp:106-113, DepthMap.h:277-281) --
    ncc_threshold_keep: float = 0.9     # max 1-NCC score accepted
    # block-synchronous checkerboard sweeps propagate slower than the
    # reference's sequential zig-zag, so run one extra iteration
    estimation_iters: int = 5           # PatchMatch iterations
    estimation_geometric_iters: int = 2 # geometric-consistency iterations
    estimation_geometric_weight: float = 0.1
    # random-refinement budget per pixel per iteration; each checkerboard
    # iteration runs 2 half-steps x (random_iters // 2) perturbations, so
    # the default 6 matches the reference's nRandomIters=6 per pixel
    random_iters: int = 6
    random_max_scale: int = 2           # initial scale-range skip cap (nRandomMaxScale)
    random_depth_ratio: float = 0.003
    random_angle1_range: float = 16.0   # deg
    random_angle2_range: float = 10.0   # deg
    random_smooth_depth: float = 0.02
    random_smooth_normal: float = 13.0  # deg
    random_smooth_bonus: float = 0.93
    exact_final_iters: int = 2      # full-res iterations scored per-texel

    # -- patch window (DepthMap.h:277-281) --
    window_half: int = 4   # 9x9 window
    window_step: int = 2   # sampled every 2 px -> 5x5 = 25 texels

    # -- alternative estimator (reference fusionMode < 0: SGM path) --
    # P1/P2/alpha/beta on uint8 costs (SemiGlobalMatcher ctor defaults:
    # P1=3 P2=4 P2alpha=14 P2beta=38; beta here at unit intensity scale)
    estimator: str = "patchmatch"   # "patchmatch" | "sgm"
    sgm_num_disparities: int = 128  # fallback global range without seeds
    sgm_p1: float = 3.0
    sgm_p2: float = 4.0
    sgm_p2_alpha: float = 14.0
    sgm_p2_beta: float = 38.0 / 255.0
    sgm_subpixel_mode: str = "lc_blend"  # na|linear|poly4|parabola|sine|cosine|lc_blend
    sgm_subpixel_steps: int = 4
    sgm_num_dirs: int = 8

    # ---- derived quantities (reference DepthEstimator ctor, DepthMap.cpp:360-410) ----
    @property
    def th_conf_small(self) -> float:
        return self.ncc_threshold_keep * 0.66

    @property
    def th_conf_big(self) -> float:
        return self.ncc_threshold_keep * 0.9

    @property
    def th_conf_rand(self) -> float:
        return self.ncc_threshold_keep * 1.1

    @property
    def th_robust(self) -> float:
        return self.ncc_threshold_keep * 4.0 / 3.0

    @property
    def smooth_bonus_depth(self) -> float:
        return 1.0 - self.random_smooth_bonus

    @property
    def smooth_bonus_normal(self) -> float:
        return (1.0 - self.random_smooth_bonus) * 0.96

    @property
    def smooth_sigma_depth(self) -> float:
        return -1.0 / (2.0 * self.random_smooth_depth ** 2)

    @property
    def smooth_sigma_normal(self) -> float:
        return -1.0 / (2.0 * math.radians(self.random_smooth_normal) ** 2)

    @property
    def num_texels(self) -> int:
        n = (2 * self.window_half + self.window_step) // self.window_step
        return n * n

    def replace(self, **kw) -> "DenseOptions":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @staticmethod
    def from_json(text: str) -> "DenseOptions":
        return DenseOptions(**json.loads(text))


@dataclass(frozen=True)
class MeshOptions:
    """Graph-cut meshing knobs (reference Scene::ReconstructMesh, Scene.h:138-141)."""

    dist_insert: float = 2.0          # px: min projected distance between inserted points
    use_free_space_support: bool = True   # library default (Scene.h:138)
    thickness_factor: float = 1.0     # kb
    # kQual: the reference default is 1.0 with CGAL's exact-predicate
    # Delaunay; Qhull's joggled tetrahedralizations carry more slivers (which
    # raise the mean facet-quality cost), so the equivalent smoothing level
    # here is ~0.8 (calibrated on the bundled scene against the reference's
    # face-count thresholds)
    quality_factor: float = 0.8       # kQual
    decimate: float = 1.0             # target face ratio in Clean()
    remove_spurious: float = 20.0
    remove_spikes: bool = True
    close_holes: int = 30
    smooth_mesh: int = 2
    # graph-cut weights (SceneReconstruct.cpp:44-56)
    sigma: float = 2.0                # kSigma (<=0: auto from point scale)
    inf_weight: float = float(1 << 24)  # kInf


@dataclass(frozen=True)
class RefineOptions:
    """Variational mesh-refinement knobs (reference Scene::RefineMesh, Scene.h:142-150)."""

    resolution_level: int = 0
    min_resolution: int = 640
    max_views: int = 8
    decimate: float = 0.0
    close_holes: int = 30
    # 0 disabled, 1 auto (remesh only alongside a decimation), 2 force
    # (RefineMesh.cpp:126, SceneRefine.cpp:552)
    ensure_edge_size: int = 1
    max_face_area: int = 32
    scales: int = 3
    scale_step: float = 0.5
    # nReduceMemory trades cached per-image mean/var for recomputation; this
    # implementation never caches them across iterations (each energy
    # evaluation computes its windowed stats in-graph), i.e. it always
    # behaves like the reduce_memory=1 reference path
    reduce_memory: int = 1
    alternative_pair: int = 0   # 0 both directions, 1 alternate, 2 (i,j), 3 (j,i)
    regularity_weight: float = 0.2
    rigidity_elasticity_ratio: float = 0.9
    gradient_step: float = 45.05
    planar_vertex_ratio: float = 0.0
    iters: int = 25


@dataclass(frozen=True)
class TextureOptions:
    """Mesh-texturing knobs (reference Scene::TextureMesh, Scene.h:152-160)."""

    resolution_level: int = 0
    min_resolution: int = 640
    outlier_threshold: float = 0.6e-2  # color-consistency outlier removal
    ratio_data_smoothness: float = 0.1
    global_seam_leveling: bool = True
    local_seam_leveling: bool = True
    texture_size_multiple: int = 0
    rect_packing_heuristic: int = 3    # MaxRects: 0 BSSF, 1 BLSF, 2 BAF,
                                       # 3 bottom-left (ref default); <0 shelf
    inference: str = "lbp"             # face-labeling MRF solver: lbp | trws
    virtual_face_threshold: float = 0.0  # deg; >0 binds coplanar face groups
    empty_color: int = 0x00FF7F27
    sharpness_weight: float = 0.5
    max_texture_size: int = 8192
