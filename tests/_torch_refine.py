"""Shared inputs of the refine gradient tests of the PyTorch port: numpy
arrays built from a seed (the inputs of tests/test_refine_grad.py)."""

import numpy as np
import torch


def toy_pair(seed=0, H=40, W=48, nv=30):
    """(verts, dict of one pair's PairData fields) of
    ``tests/test_refine_grad.py::_toy_pair``: random vertices, random face
    ids and barycentrics per pixel, and a neighbour camera shifted by 0.3."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1, 1, (nv, 3)).astype(np.float32)
    verts[:, 2] += 5.0
    fv = rng.integers(0, nv, (H, W, 3)).astype(np.int32)
    bar = rng.uniform(0.1, 1, (H, W, 3)).astype(np.float32)
    bar /= bar.sum(-1, keepdims=True)
    mask = rng.random((H, W)) < 0.9
    f = 60.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    Rb = np.eye(3, dtype=np.float32)
    Cb = np.array([0.3, 0.0, 0.0], np.float32)
    KB_R = K @ Rb
    pd = dict(
        imgA=rng.uniform(0, 1, (H, W)).astype(np.float32),
        imgB=rng.uniform(0, 1, (H, W)).astype(np.float32),
        face_vid=fv, bary=bar, mask=mask, KA_R=K,
        KA_t=np.zeros(3, np.float32), KB_R=KB_R,
        KB_t=(-(KB_R @ Cb)).astype(np.float32),
        sizeB=np.asarray([H, W], np.float32), CA=np.zeros(3, np.float32),
        reg_scale=np.float32(1.0))
    return verts, pd


def with_faces(pd, faces, fid):
    """The pair seen through a face-id raster: face_vid = faces[fid], the
    mask cut to pixels with a face, and fid set (the per-face path)."""
    return dict(pd, face_vid=faces[np.maximum(fid, 0)].astype(np.int32),
                mask=pd["mask"] & (fid >= 0), fid=fid.astype(np.int32))


def stack(pds):
    """Dicts of per-pair arrays stacked on a leading pair axis."""
    return {k: np.stack([np.asarray(p[k]) for p in pds]) for k in pds[0]}


def port_pairs(d, device="cpu"):
    """The port's PairData from a dict of stacked arrays."""
    from openmvs_tpu_torch.refine import PairData

    t = {k: torch.from_numpy(np.array(v, order="C", copy=True)).to(device)
         for k, v in d.items()}
    t["face_vid"] = t["face_vid"].long()
    return PairData(**t)


def random_faces(nv, n, seed):
    """n random non-degenerate triangles over nv vertices."""
    rng = np.random.default_rng(seed)
    faces = rng.integers(0, nv, (n, 3))
    return faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                 & (faces[:, 0] != faces[:, 2])]


def allclose_to_max(a, b, rtol=1e-4, atol_of_max=1e-6):
    """assert_allclose with the absolute tolerance a fraction of max|b|,
    the form tests/test_refine_grad.py uses."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_of_max * max(np.abs(b).max(), 1e-6))
