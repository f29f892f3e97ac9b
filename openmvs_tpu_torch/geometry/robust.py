"""Robust loss functors (libs/Math/RobustNorms.h equivalents).

Each norm maps a residual magnitude r to (rho, weight):
  rho(r)    — the robustified cost contribution,
  weight(r) — the IRLS weight rho'(r)/r used by reweighted least squares.

All are plain elementwise math on numpy arrays.

A copy of ``openmvs_tpu/geometry/robust.py`` (host numpy in both packages;
the RNG draws of ``ac_ransac_plane`` in the same order).
"""

from __future__ import annotations

import numpy as np


def l2(r, scale=1.0):
    return 0.5 * r * r, np.ones_like(r)


def huber(r, scale=1.345):
    """Quadratic near zero, linear in the tails (RobustNorms.h Huber)."""
    a = np.abs(r)
    quad = a <= scale
    rho = np.where(quad, 0.5 * r * r, scale * (a - 0.5 * scale))
    w = np.where(quad, 1.0, scale / np.maximum(a, 1e-30))
    return rho, w


def tukey(r, scale=4.6851):
    """Hard redescending biweight: outliers beyond `scale` contribute a
    constant cost and zero gradient (RobustNorms.h Tukey)."""
    u = r / scale
    inl = np.abs(u) <= 1.0
    t = 1.0 - u * u
    rho = np.where(inl, (scale * scale / 6.0) * (1.0 - t * t * t),
                   scale * scale / 6.0)
    w = np.where(inl, t * t, 0.0)
    return rho, w


def geman_mcclure(r, scale=1.0):
    """Soft redescending norm rho = r^2/2 / (1 + (r/s)^2)
    (RobustNorms.h GemanMcClure)."""
    u2 = (r / scale) ** 2
    den = 1.0 + u2
    rho = 0.5 * r * r / den
    w = 1.0 / (den * den)
    return rho, w


def cauchy(r, scale=2.3849):
    u2 = (r / scale) ** 2
    rho = 0.5 * scale * scale * np.log1p(u2)
    w = 1.0 / (1.0 + u2)
    return rho, w


NORMS = {
    "l2": l2,
    "huber": huber,
    "tukey": tukey,
    "geman_mcclure": geman_mcclure,
    "cauchy": cauchy,
}


def ac_ransac_plane(points, max_threshold: float = 0.0, iters: int = 1024,
                    seed: int = 0, max_eval: int = 50000):
    """A-contrario RANSAC plane fit (Common/AutoEstimator.h ACRANSAC with
    the TPlaneSolverAdaptor kernel, DepthMap.cpp:1255-1360).

    The inlier threshold is not a parameter: for each minimal-sample model
    the Number of False Alarms is minimized over the sorted residuals

        log10 NFA(k) = loge0 + (k-s) * (logalpha0 + 0.5*log10 e_k)
                       + log10 C(n,k) + log10 C(k,s)

    with logalpha0 = log10(2*D/(2*V)) from the bounding-box diameter/volume
    (scale invariance) and squared point-plane residuals (multError = 0.5).

    Returns (n, d, inlier_mask, threshold, log10_nfa); n·x + d = 0.
    """
    from scipy.special import gammaln

    P = np.asarray(points, np.float64).reshape(-1, 3)
    n_pts = len(P)
    s = 3
    if n_pts < 4:
        raise ValueError("need >= 4 points")
    rng = np.random.default_rng(seed)
    # subsample the EVALUATION set for very large clouds (sampling stays on
    # the full set; NFA uses the evaluated count)
    if n_pts > max_eval:
        eval_idx = rng.choice(n_pts, max_eval, replace=False)
    else:
        eval_idx = np.arange(n_pts)
    E = P[eval_idx]
    n_eval = len(E)

    ext = P.max(axis=0) - P.min(axis=0)
    D = float(np.linalg.norm(ext))
    # guard degenerate (near-flat) extents with a FRACTION of the diameter,
    # not an absolute +1: an absolute term breaks the NFA's scale
    # invariance for scenes whose bounding box is not >> 1 unit
    ext = np.maximum(ext.astype(np.float64), 1e-3 * max(D, 1e-30))
    V = float(np.prod(ext))
    logalpha0 = np.log10(2.0 * D / V * 0.5)
    loge0 = np.log10(1.0 * max(n_eval - s, 1))
    ln10 = np.log(10.0)
    k_arr = np.arange(n_eval + 1, dtype=np.float64)
    logc_n = (gammaln(n_eval + 1) - gammaln(k_arr + 1)
              - gammaln(n_eval - k_arr + 1)) / ln10
    logc_k = np.where(
        k_arr >= s,
        (gammaln(k_arr + 1) - gammaln(s + 1.0)
         - gammaln(np.maximum(k_arr - s, 0) + 1)) / ln10,
        np.inf)
    ks = np.arange(s + 1, n_eval + 1)
    kfac = (ks - s).astype(np.float64)
    max_t_sq = max_threshold * max_threshold if max_threshold > 0 else np.inf

    best = (np.inf, None, np.inf)
    for _ in range(iters):
        i = rng.choice(n_pts, 3, replace=False)
        v1, v2 = P[i[1]] - P[i[0]], P[i[2]] - P[i[0]]
        nrm = np.cross(v1, v2)
        nn = np.linalg.norm(nrm)
        if nn < 1e-12:
            continue
        nrm = nrm / nn
        d = -nrm @ P[i[0]]
        e_sq = np.sort((E @ nrm + d) ** 2)
        ek = e_sq[ks - 1]
        nfa = (loge0 + (logalpha0 + 0.5 * np.log10(ek + 1e-30)) * kfac
               + logc_n[ks] + logc_k[ks])
        nfa = np.where(ek <= max_t_sq, nfa, np.inf)
        j = int(np.argmin(nfa))
        if nfa[j] < best[0]:
            best = (float(nfa[j]), (nrm, d), float(ek[j]))
    if best[1] is None:
        raise ValueError("no valid plane model found")
    (nrm, d), t_sq = best[1], best[2]
    # refit on the NFA-selected inliers (the reference re-runs the estimator
    # on inliers; a least-squares refit is this solver's equivalent)
    for _ in range(2):
        m = (P @ nrm + d) ** 2 <= t_sq
        if m.sum() < 3:
            break
        c = P[m].mean(axis=0)
        _, _, Vt = np.linalg.svd(P[m] - c, full_matrices=False)
        nrm = Vt[2] / np.linalg.norm(Vt[2])
        d = -float(nrm @ c)
    mask = (P @ nrm + d) ** 2 <= t_sq
    return nrm, d, mask, float(np.sqrt(t_sq)), best[0]
