"""SML ("Simple Markup Language") text-config codec.

A copy of ``openmvs_tpu/io/sml.py``. The reference stores its OPTDENSE
workspace (and any CConfigTable) as SML files — e.g. the `Densify.ini`
written/read by DensifyPointCloud
(apps/DensifyPointCloud/DensifyPointCloud.cpp:238-255).  Format
(libs/Common/SML.{h,cpp}, tokens at SML.cpp:22-37):

    Name = value          # one pair per line, '=' separator, ws-trimmed
    Other Name = 12.5     # names may contain spaces (option TITLES)

    [ChildSection]
    {
        Nested Name = 1   # sections nest arbitrarily, '\t' indent on save
    }

Values run to end-of-line.  A line inside a section block without '=' is
auto-named "ItemN" by the reference (SML_AUTOVALUES_ON, SML.cpp:183-189);
we reproduce that so reference-written files round-trip.
"""

from __future__ import annotations

from typing import Dict, Tuple


class SMLNode:
    """One SML section: ordered (name -> string value) + named children."""

    def __init__(self, name: str = ""):
        self.name = name
        self.values: Dict[str, str] = {}
        self.children: Dict[str, "SMLNode"] = {}

    def child(self, name: str) -> "SMLNode":
        if name not in self.children:
            self.children[name] = SMLNode(name)
        return self.children[name]

    def __getitem__(self, key: str) -> str:
        return self.values[key]

    def get(self, key: str, default=None):
        return self.values.get(key, default)


def parse_sml(text: str) -> SMLNode:
    """Parse SML text into a root SMLNode."""
    root = SMLNode()
    stack = [root]
    pending_name = None  # section name seen, waiting for '{'
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if pending_name is not None:
            if line.startswith("{"):
                stack.append(stack[-1].child(pending_name))
                pending_name = None
                line = line[1:].strip()
                if not line:
                    continue
            else:
                # orphan [name] without a block: treat as empty child
                stack[-1].child(pending_name)
                pending_name = None
        if line.startswith("[") and line.endswith("]"):
            pending_name = line[1:-1].strip()
            continue
        if line.startswith("}"):
            if len(stack) > 1:
                stack.pop()
            continue
        node = stack[-1]
        if "=" in line:
            name, _, val = line.partition("=")
            name = name.strip()
            if not name:
                name = f"Item{len(node.values)}"
            node.values[name] = val.strip()
        else:
            # SML_AUTOVALUES_ON: value with no '=' gets an auto name
            node.values[f"Item{len(node.values)}"] = line
    return root


def dump_sml(node: SMLNode, indent: str = "") -> str:
    """Serialize in the reference's save layout (SML.cpp:236-288)."""
    out = []
    for name, val in node.values.items():
        out.append(f"{indent}{name} = {val}\n")
    first = not node.values
    for child in node.children.values():
        if not child.values and not child.children:
            continue  # reference skips empty children unless SAVEEMPTY
        if first:
            first = False
        else:
            out.append("\n")
        out.append(f"{indent}[{child.name}]\n{indent}{{\n")
        out.append(dump_sml(child, indent + "\t"))
        out.append(f"{indent}}}\n")
    return "".join(out)


def load_sml(path: str) -> SMLNode:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_sml(f.read())


def save_sml(node: SMLNode, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dump_sml(node))


# ------------------------------------------------------------------
# OPTDENSE workspace mapping: reference option TITLE -> DenseOptions field.
# Titles from libs/MVS/DepthMap.cpp:69-113 (the MDEFVAR/DEFVAR declarations).
# ------------------------------------------------------------------
_I, _F, _B = int, float, lambda s: s.strip().lower() in ("1", "true", "yes", "on")

OPTDENSE_TITLE_TO_FIELD = {
    "Resolution Level": ("resolution_level", _I),
    "Max Resolution": ("max_resolution", _I),
    "Min Resolution": ("min_resolution", _I),
    "SubResolution levels": ("sub_resolution_levels", _I),
    "Min Views": ("min_views", _I),
    "Max Views": ("max_views", _I),
    "Min Views Fuse": ("min_views_fuse", _I),
    "Min Views Filter": ("min_views_filter", _I),
    "Min Views Filter Adjust": ("min_views_filter_adjust", _I),
    "Min Views Trust Point": ("min_views_trust_point", _I),
    "Num Views": ("num_views", _I),
    "Point Inside ROI": ("point_inside_roi", _I),
    "Filter Adjust": ("filter_adjust", _B),
    "Add Corners": ("add_corners", _B),
    "Init Sparse": ("init_sparse", _B),
    "Remove Dmaps": ("remove_dmaps", _B),
    "View Min Score": ("view_min_score", _F),
    "View Min Score Ratio": ("view_min_score_ratio", _F),
    "Min Area": ("min_area", _F),
    "Min Angle": ("min_angle", _F),
    "Optim Angle": ("optim_angle", _F),
    "Max Angle": ("max_angle", _F),
    "Descriptor Min Magnitude Threshold": ("descriptor_min_magnitude", _F),
    "Depth Diff Threshold": ("depth_diff_threshold", _F),
    "Normal Diff Threshold": ("normal_diff_threshold", _F),
    "Speckle Size": ("speckle_size", _I),
    "Interpolate Gap Size": ("ipol_gap_size", _I),
    "Ignore Mask Label": ("ignore_mask_label", _I),
    "Optimize": ("optimize", _I),
    "Estimate Colors": ("estimate_colors", _I),
    "Estimate Normals": ("estimate_normals", _I),
    "NCC Threshold Keep": ("ncc_threshold_keep", _F),
    "Estimation Iters": ("estimation_iters", _I),
    "Estimation Geometric Iters": ("estimation_geometric_iters", _I),
    "Estimation Geometric Weight": ("estimation_geometric_weight", _F),
    "Random Iters": ("random_iters", _I),
    "Random Max Scale": ("random_max_scale", _I),
    "Random Depth Ratio": ("random_depth_ratio", _F),
    "Random Angle1 Range": ("random_angle1_range", _F),
    "Random Angle2 Range": ("random_angle2_range", _F),
    "Random Smooth Depth": ("random_smooth_depth", _F),
    "Random Smooth Normal": ("random_smooth_normal", _F),
    "Random Smooth Bonus": ("random_smooth_bonus", _F),
    # declared by the reference but role-less here (the nNumViews==1 pairing
    # MRF is solved exactly as max-weight matching, config.py note): accepted
    # and ignored so reference files load cleanly
    "Pairwise Mul": (None, None),
    "Optimizer Eps": (None, None),
    "Optimizer Max Iters": (None, None),
}


def dense_options_from_sml(path: str, base=None):
    """Load a reference OPTDENSE workspace file (SML text, e.g. the
    `--dense-config-file` of DensifyPointCloud) into a DenseOptions.

    Unknown titles are ignored with a warning (forward compatibility with
    other reference versions); role-less titles are silently accepted."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.utils.log import get_logger

    node = load_sml(path)
    # tolerate both a flat file (OPTDENSE::oConfig.Save output) and one
    # wrapping the workspace in a [Dense...] section
    if not node.values and len(node.children) == 1:
        node = next(iter(node.children.values()))
    kw = {}
    for title, val in node.values.items():
        entry = OPTDENSE_TITLE_TO_FIELD.get(title)
        if entry is None:
            get_logger("config").warning("SML: unknown OPTDENSE option %r", title)
            continue
        field, conv = entry
        if field is None:
            continue
        try:
            kw[field] = conv(val)
        except ValueError:
            get_logger("config").warning("SML: bad value %r for %r", val, title)
    base = base if base is not None else DenseOptions()
    return base.replace(**kw)


def dense_options_to_sml(opts, path: str) -> None:
    """Write a DenseOptions as a reference-loadable OPTDENSE SML file."""
    node = SMLNode()
    for title, (field, conv) in OPTDENSE_TITLE_TO_FIELD.items():
        if field is None:
            continue
        v = getattr(opts, field)
        if conv is _B:
            v = int(bool(v))
        node.values[title] = str(v)
    save_sml(node, path)
