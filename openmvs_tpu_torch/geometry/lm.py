"""Levenberg-Marquardt nonlinear least squares (libs/Math/LMFit/lmmin role).

A compact damped Gauss-Newton solver for the small host-side fitting
problems the reference routes through lmfit (similarity-transform
refinement, plane/curve fits): numeric or analytic Jacobians, optional
robust IRLS weighting via geometry.robust norms.

A copy of ``openmvs_tpu/geometry/lm.py`` (host numpy and scipy in both
packages).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from openmvs_tpu_torch.geometry import robust as robust_norms


def _numeric_jacobian(fn, x, f0, eps=1e-7):
    J = np.empty((len(f0), len(x)))
    for j in range(len(x)):
        step = eps * max(1.0, abs(x[j]))
        xp = x.copy()
        xp[j] += step
        J[:, j] = (fn(xp) - f0) / step
    return J


def lm_fit(
    residual_fn: Callable[[np.ndarray], np.ndarray],
    x0: np.ndarray,
    jac: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_iters: int = 100,
    ftol: float = 1e-10,
    xtol: float = 1e-10,
    lam0: float = 1e-3,
    robust: Optional[str] = None,
    robust_scale: float = 1.345,
):
    """Minimize sum rho(residual_fn(x)) over x.

    Returns (x, cost, n_iters).  `robust` selects an IRLS norm from
    geometry.robust (None = plain least squares, lmmin behavior)."""
    x = np.asarray(x0, np.float64).copy()
    lam = lam0
    norm = robust_norms.NORMS[robust] if robust else None

    def cost_and_weights(f):
        if norm is None:
            return 0.5 * float(f @ f), None
        rho, w = norm(f, robust_scale)
        return float(np.sum(rho)), w

    f = np.asarray(residual_fn(x), np.float64)
    cost, w = cost_and_weights(f)
    it = 0
    for it in range(1, max_iters + 1):
        J = np.asarray(jac(x) if jac is not None else
                       _numeric_jacobian(residual_fn, x, f), np.float64)
        if w is not None:
            sw = np.sqrt(np.maximum(w, 0.0))
            Jw = J * sw[:, None]
            fw = f * sw
        else:
            Jw, fw = J, f
        JtJ = Jw.T @ Jw
        g = Jw.T @ fw
        if np.linalg.norm(g, np.inf) < ftol:
            break
        ok = False
        for _ in range(12):
            A = JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-12))
            try:
                dx = np.linalg.solve(A, -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            x_new = x + dx
            f_new = np.asarray(residual_fn(x_new), np.float64)
            cost_new, w_new = cost_and_weights(f_new)
            if cost_new < cost:
                rel = (cost - cost_new) / max(cost, 1e-300)
                x, f, cost, w = x_new, f_new, cost_new, w_new
                lam = max(lam * 0.3, 1e-12)
                ok = True
                if rel < ftol or np.linalg.norm(dx) < xtol * (
                        np.linalg.norm(x) + xtol):
                    return x, cost, it
                break
            lam *= 10
        if not ok:
            break
    return x, cost, it


def refine_similarity(
    src: np.ndarray, dst: np.ndarray, T0: np.ndarray, scale0: float,
    robust: Optional[str] = "huber",
):
    """LM-refine a 7-DoF similarity (the reference refines its closed-form
    SimilarityTransform estimate with lmmin, Math/SimilarityTransform.cpp).

    Parameterization: (3 rotvec, 3 translation, log scale) around T0.
    Returns (T 4x4, scale)."""
    from scipy.spatial.transform import Rotation

    R0 = T0[:3, :3] / scale0
    t0 = T0[:3, 3]
    rv0 = Rotation.from_matrix(R0).as_rotvec()
    x0 = np.concatenate([rv0, t0, [np.log(scale0)]])

    def residual(x):
        R = Rotation.from_rotvec(x[:3]).as_matrix()
        s = np.exp(x[6])
        pred = s * src @ R.T + x[3:6]
        return (pred - dst).reshape(-1)

    # two-stage robust schedule with MAD-estimated scales: Huber first
    # (convex, pulls the estimate near the inlier consensus), then the
    # redescending Tukey to fully reject gross outliers
    x = x0
    if robust:
        for norm, k in (("huber", 1.48), (("tukey"), 4.68)):
            r = np.abs(residual(x))
            mad = np.median(r[r > 0]) if (r > 0).any() else 1.0
            x, _, _ = lm_fit(residual, x, robust=norm,
                             robust_scale=max(k * mad, 1e-9))
    else:
        x, _, _ = lm_fit(residual, x)
    R = Rotation.from_rotvec(x[:3]).as_matrix()
    s = float(np.exp(x[6]))
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = x[3:6]
    return T, s
