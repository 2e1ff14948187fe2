"""Tiny dependency-free optimizers used to fit calibration surfaces.

The paper fits a polynomial regression to extrapolate ``C_max`` beyond the
largest measured core count; we additionally fit parametric calibration
surfaces to published table data (see ``calibration.fit_hopper_calibration``).
scipy is not available offline, so we carry a small Nelder--Mead and a
least-squares polynomial fit on plain numpy.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def polyfit(x: Sequence[float], y: Sequence[float], deg: int) -> np.ndarray:
    """Least-squares polynomial fit; returns coefficients, highest power first."""
    return np.polyfit(np.asarray(x, dtype=float), np.asarray(y, dtype=float), deg)


def polyval(coeffs: np.ndarray, x) -> np.ndarray:
    return np.polyval(coeffs, x)


def ridge_lstsq(A: np.ndarray, b: np.ndarray, lam: float = 0.0) -> np.ndarray:
    """Regularized least squares: argmin ||A x - b||^2 + lam ||x||^2.

    The L2 penalty shrinks the solution toward zero, which is exactly what
    online recalibration wants — a handful of noisy measured runs should
    nudge a model parameter, not yank it (lam = 0 recovers plain lstsq).

    Solved as lstsq on the ridge-augmented system [A; sqrt(lam) I], which
    keeps A's conditioning (no normal equations) and degrades to the
    least-norm solution for singular A at lam = 0, like np.linalg.lstsq."""
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float)
    if A.ndim == 1:
        A = A[:, None]
    n = A.shape[1]
    A_aug = np.vstack([A, float(np.sqrt(max(lam, 0.0))) * np.eye(n)])
    b_aug = np.concatenate([b, np.zeros(n)])
    x, *_ = np.linalg.lstsq(A_aug, b_aug, rcond=None)
    return x


def nelder_mead(
    f: Callable[[np.ndarray], float],
    x0: np.ndarray,
    *,
    step: float = 0.25,
    max_iter: int = 2000,
    xatol: float = 1e-8,
    fatol: float = 1e-10,
) -> tuple[np.ndarray, float]:
    """Minimal Nelder--Mead simplex minimizer (Lagarias et al. parameters)."""
    x0 = np.asarray(x0, dtype=float)
    n = x0.size
    # Initial simplex: x0 plus per-coordinate perturbations.
    simplex = [x0]
    for i in range(n):
        xi = x0.copy()
        xi[i] = xi[i] + (step * abs(xi[i]) if xi[i] != 0 else step)
        simplex.append(xi)
    simplex = np.asarray(simplex)
    fvals = np.asarray([f(x) for x in simplex], dtype=float)

    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
    for _ in range(max_iter):
        order = np.argsort(fvals)
        simplex, fvals = simplex[order], fvals[order]
        if (np.max(np.abs(simplex[1:] - simplex[0])) < xatol
                and np.max(np.abs(fvals[1:] - fvals[0])) < fatol):
            break
        centroid = simplex[:-1].mean(axis=0)
        # Reflection
        xr = centroid + alpha * (centroid - simplex[-1])
        fr = f(xr)
        if fvals[0] <= fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
            continue
        if fr < fvals[0]:
            # Expansion
            xe = centroid + gamma * (xr - centroid)
            fe = f(xe)
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
            else:
                simplex[-1], fvals[-1] = xr, fr
            continue
        # Contraction
        xc = centroid + rho * (simplex[-1] - centroid)
        fc = f(xc)
        if fc < fvals[-1]:
            simplex[-1], fvals[-1] = xc, fc
            continue
        # Shrink
        for i in range(1, n + 1):
            simplex[i] = simplex[0] + sigma * (simplex[i] - simplex[0])
            fvals[i] = f(simplex[i])
    order = np.argsort(fvals)
    return simplex[order][0], float(fvals[order][0])


def multistart_nelder_mead(
    f: Callable[[np.ndarray], float],
    x0: np.ndarray,
    *,
    n_starts: int = 8,
    spread: float = 0.5,
    seed: int = 0,
    **kw,
) -> tuple[np.ndarray, float]:
    """Nelder--Mead from several jittered starts; returns the best optimum."""
    rng = np.random.default_rng(seed)
    best_x, best_f = nelder_mead(f, x0, **kw)
    for _ in range(n_starts - 1):
        jitter = 1.0 + spread * rng.standard_normal(np.asarray(x0).size)
        x, fx = nelder_mead(f, np.asarray(x0) * jitter, **kw)
        if fx < best_f:
            best_x, best_f = x, fx
    return best_x, best_f
