"""The port's hand-derived refine gradients against torch.autograd, as
tests/test_refine_grad.py holds the JAX package's against jax.grad (same
inputs, same tolerances)."""

import numpy as np
import torch

from _torch_refine import (allclose_to_max, port_pairs, random_faces, stack,
                           toy_pair, with_faces)

torch.set_num_threads(1)


def test_pair_grad_matches_autograd():
    from openmvs_tpu_torch.refine import _pair_energy, _pair_energy_grad_manual

    verts, pd = toy_pair()
    pds = port_pairs(stack([pd]))
    v = torch.from_numpy(verts).requires_grad_(True)
    e_ad = _pair_energy(v, pds)
    (g_ad,) = torch.autograd.grad(e_ad.sum(), v)
    e_m, g_m, sup, n_valid = _pair_energy_grad_manual(torch.from_numpy(verts), pds)
    assert float(n_valid[0]) > 0
    assert abs(float(e_ad[0].detach()) - float(e_m[0])) < 1e-6
    ga, gm = g_ad.numpy(), g_m[0].numpy()
    assert np.abs(ga - gm).max() < 1e-5 * max(np.abs(ga).max(), 1e-6)
    # support flags gate exactly the vertices with a nonzero autograd gradient
    s = sup[0].numpy()
    assert set(np.unique(s)) <= {0.0, 1.0}
    assert not np.any((s == 0) & (np.abs(ga).max(axis=1) > 1e-7))


def test_face_scatter_path_matches_vertex_path():
    """The per-face scatter (_pairs_grad_faces, used when PairData.fid is
    present) reproduces the per-vertex path's energies, photometric
    gradient and support counts up to float reduction order."""
    from openmvs_tpu_torch.refine import _pair_energy_grad_manual, _pairs_grad_faces

    rng = np.random.default_rng(4)
    nv, nf, H, W = 30, 50, 40, 48
    faces = rng.integers(0, nv, (nf, 3)).astype(np.int32)
    fid = rng.integers(-1, nf, (H, W)).astype(np.int32)
    verts, pd0 = toy_pair(seed=0, H=H, W=W, nv=nv)
    _, pd1 = toy_pair(seed=3, H=H, W=W, nv=nv)
    pds = port_pairs(stack([with_faces(pd, faces, fid) for pd in (pd0, pd1)]))
    v = torch.from_numpy(verts)

    es_f, g_f, n_sup_f = _pairs_grad_faces(v, pds, torch.from_numpy(faces).long())
    es_v, gs, sups, n_valids = _pair_energy_grad_manual(v, pds)
    w_pair = (n_valids * pds.reg_scale)[:, None, None]
    g_v = torch.sum(gs * w_pair, dim=0)
    n_sup_v = torch.sum(sups, dim=0)

    np.testing.assert_allclose(es_f.numpy(), es_v.numpy(), rtol=1e-6, atol=1e-7)
    allclose_to_max(g_f.numpy(), g_v.numpy())
    np.testing.assert_array_equal(n_sup_f.numpy(), n_sup_v.numpy())


def test_smooth_grad_matches_autograd():
    from openmvs_tpu_torch.refine import (_smooth_energy, _smooth_energy_grad_manual,
                                          _vertex_adjacency)

    nv = 25
    faces = random_faces(nv, 40, seed=1)
    adj, deg = _vertex_adjacency(faces, nv)
    verts = np.random.default_rng(1).normal(size=(nv, 3)).astype(np.float32)
    adj_t = torch.from_numpy(adj).long()
    deg_t = torch.from_numpy(deg.astype(np.float32))
    v = torch.from_numpy(verts).requires_grad_(True)
    e_ad = _smooth_energy(v, adj_t, deg_t)
    (g_ad,) = torch.autograd.grad(e_ad, v)
    e_m, g_m = _smooth_energy_grad_manual(torch.from_numpy(verts), adj_t, deg_t)
    assert abs(float(e_ad.detach()) - float(e_m)) < 1e-6
    np.testing.assert_allclose(g_m.numpy(), g_ad.numpy(), rtol=1e-4, atol=1e-6)
