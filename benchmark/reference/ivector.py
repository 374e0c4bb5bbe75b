"""Plain reference of i-vector extraction (Kaldi's ivector-extract over a
full-covariance UBM, ivector/ivector-extractor.cc, as egs/sre10/v1's
sid/extract_ivectors.sh runs it), in plain PyTorch.

- Gaussian selection: each frame's `num_gselect` best gaussians by the
  diagonal UBM's log-likelihood (the diagonal of each inverse covariance,
  inverted), their posteriors normalised over the selection, those under
  `min_post` dropped and the rest renormalised.
- Statistics: gamma_i = sum_t p_ti, X_i = sum_t p_ti x_t.
- The i-vector: the mean of w's posterior under w ~ N([prior_offset, 0,
  ...], I), with L = I + sum_i gamma_i M_i' S_i^-1 M_i and b = sum_i
  M_i' S_i^-1 (X_i - gamma_i mu_i) + [prior_offset, 0, ...]; w = L^-1 b,
  prior_offset taken back off coordinate 0.

`dtype` is the arithmetic: f64 is the reference; the control runs the
statistics and the i-vector in f32 (gselect is f32 in the configuration
and stays so in the control). Nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch


def gselect_posteriors(x: torch.Tensor, means: torch.Tensor,
                       inv_covars: torch.Tensor, weights: torch.Tensor,
                       num_gselect: int, min_post: float,
                       dtype=torch.float64) -> torch.Tensor:
    """x [T, D] -> dense posteriors [T, I] in `dtype`."""
    var = 1.0 / torch.clamp(torch.diagonal(inv_covars, dim1=1, dim2=2),
                            min=1e-10)
    x = x.to(dtype)
    var, mu, w = var.to(dtype), means.to(dtype), weights.to(dtype)
    D = x.shape[1]
    gconst = torch.log(w) - 0.5 * (D * math.log(2 * math.pi)
                                   + torch.log(var).sum(1)
                                   + (mu * mu / var).sum(1))
    ll = gconst + x @ (mu / var).T - 0.5 * (x * x) @ (1.0 / var).T
    sel, idx = torch.topk(ll, min(num_gselect, ll.shape[1]), dim=1)
    p = torch.softmax(sel, dim=1)
    p = torch.where(p < min_post, torch.zeros_like(p), p)
    s = p.sum(dim=1, keepdim=True)
    p = torch.where(s > 0, p / torch.where(s > 0, s, torch.ones_like(s)), p)
    return torch.zeros_like(ll).scatter_(1, idx, p)


def stats(post: torch.Tensor, x: torch.Tensor):
    """-> (gamma [I], X [I, D]) in post's dtype."""
    return post.sum(dim=0), post.T @ x.to(post.dtype)


def ivector(gamma: torch.Tensor, X: torch.Tensor, means: torch.Tensor,
            inv_covars: torch.Tensor, M: torch.Tensor,
            prior_offset: float) -> torch.Tensor:
    """-> the i-vector [K] in gamma's dtype."""
    dt = gamma.dtype
    M, P, mu = M.to(dt), inv_covars.to(dt), means.to(dt)
    PM = P @ M                                        # [I, D, K]
    K = M.shape[2]
    L = torch.eye(K, dtype=dt, device=M.device) + torch.einsum(
        "idk,idj->kj", M, gamma[:, None, None] * PM)
    b = torch.einsum("idk,id->k", PM, X.to(dt) - gamma[:, None] * mu)
    b[0] += prior_offset
    w = torch.cholesky_solve(b[:, None], torch.linalg.cholesky(L))[:, 0]
    w[0] -= prior_offset
    return w
