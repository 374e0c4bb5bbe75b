"""General-purpose optimizers: L-BFGS and preconditioned conjugate gradients.

(ref: matrix/optimization.h — OptimizeLbfgs :121 and LinearCgd :63; used by
 the reference for nnet-combine-fast and SGMM auxiliary solves. Host-side
 numpy: these run on small parameter vectors off the hot path.)

The port's copy of kaldi_tpu/utils/optimization.py (host code), carried
verbatim so the port imports nothing of kaldi_tpu; tests/test_torch_*.py
hold the two equal.
"""

from __future__ import annotations

import numpy as np


def lbfgs(f_and_grad, x0: np.ndarray, max_iters: int = 100, m: int = 10,
          tol: float = 1e-8, c1: float = 1e-4, c2: float = 0.9):
    """Minimize f via L-BFGS with a Wolfe backtracking line search.

    f_and_grad(x) -> (value, gradient). Returns (x, f(x), n_iters).
    (ref: matrix/optimization.h:121 OptimizeLbfgs.)"""
    x = np.asarray(x0, np.float64).copy()
    f, g = f_and_grad(x)
    s_list: list = []
    y_list: list = []
    for it in range(max_iters):
        if np.linalg.norm(g) < tol:
            return x, f, it
        # two-loop recursion
        q = g.copy()
        alphas = []
        for s, y in reversed(list(zip(s_list, y_list))):
            rho = 1.0 / max(float(y @ s), 1e-20)
            a = rho * (s @ q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if y_list:
            s, y = s_list[-1], y_list[-1]
            q *= float(s @ y) / max(float(y @ y), 1e-20)
        for (a, rho, s, y) in reversed(alphas):
            b = rho * (y @ q)
            q += (a - b) * s
        d = -q
        if d @ g >= 0:          # safeguard: fall back to steepest descent
            d = -g
        # Wolfe line search: backtrack on Armijo failure, expand while the
        # directional derivative is still steeply negative (curvature)
        step = 1.0
        gd = g @ d
        best = None
        for _ in range(50):
            x_try = x + step * d
            f_try, g_try = f_and_grad(x_try)
            if f_try <= f + c1 * step * gd:
                best = (x_try, f_try, g_try)
                if g_try @ d >= c2 * gd:     # curvature satisfied
                    break
                step *= 2.1                  # too short: expand
            else:
                step *= 0.5                  # overshoot: backtrack
        if best is None:
            return x, f, it
        x_new, f_new, g_new = best
        s_vec = x_new - x
        y_vec = g_new - g
        if s_vec @ y_vec > 1e-12:
            s_list.append(s_vec)
            y_list.append(y_vec)
            if len(s_list) > m:
                s_list.pop(0)
                y_list.pop(0)
        if abs(f - f_new) < tol * max(1.0, abs(f)):
            return x_new, f_new, it + 1
        x, f, g = x_new, f_new, g_new
    return x, f, max_iters


def linear_cgd(A, b: np.ndarray, x0: np.ndarray | None = None,
               max_iters: int | None = None, tol: float = 1e-10,
               precond=None):
    """Solve A x = b (A SPD: matrix or matvec callable) by (preconditioned)
    conjugate gradients (ref: matrix/optimization.h:63 LinearCgd).
    Returns (x, n_iters)."""
    n = b.shape[0]
    matvec = A if callable(A) else (lambda v: A @ v)
    M = precond if precond is not None else (lambda v: v)
    x = np.zeros(n) if x0 is None else np.asarray(x0, np.float64).copy()
    r = b - matvec(x)
    z = M(r)
    p = z.copy()
    rz = float(r @ z)
    max_iters = max_iters or 2 * n
    for it in range(max_iters):
        if np.sqrt(max(rz, 0.0)) < tol * max(1.0, np.linalg.norm(b)):
            return x, it
        Ap = matvec(p)
        denom = float(p @ Ap)
        if denom <= 0:
            return x, it
        alpha = rz / denom
        x += alpha * p
        r -= alpha * Ap
        z = M(r)
        rz_new = float(r @ z)
        p = z + (rz_new / max(rz, 1e-300)) * p
        rz = rz_new
    return x, max_iters


def est_pca(data: np.ndarray, target_dim: int,
            normalize_variance: bool = False,
            normalize_mean: bool = True):
    """PCA transform [target_dim, D(+1)] (ref: matrix/matrix-functions.h:204
    ComputePca / bin/est-pca.cc). Apply to [x; 1] when normalize_mean."""
    x = np.asarray(data, np.float64)
    mu = x.mean(axis=0)
    cov = (x - mu).T @ (x - mu) / len(x)
    w, V = np.linalg.eigh(cov)
    order = np.argsort(w)[::-1][:target_dim]
    proj = V[:, order].T
    if normalize_variance:
        proj = proj / np.sqrt(np.maximum(w[order], 1e-20))[:, None]
    D = x.shape[1]
    out = np.zeros((target_dim, D + 1))
    out[:, :D] = proj
    if normalize_mean:
        out[:, D] = -proj @ mu
    return out
