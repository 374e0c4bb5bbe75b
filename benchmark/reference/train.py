"""Plain reference of the TDNN's training step: the valid-mode relu TDNN
(each layer splices its input at its offsets without padding, an affine
map, a relu, a renormalisation to unit RMS; a final affine and a
log-softmax), the frame-weighted mean cross-entropy over the batch, the
gradient by autograd, the global gradient norm clipped at max_grad_norm
(g unchanged under it, g / norm * max_norm over it), then SGD at the
step's rate. Plain PyTorch; nothing of the program is imported.

`precision` selects the products: "f64" is the reference; "fp8" is the
control, one step below the bf16 products the configuration states:
every product of the forward and backward passes takes float8 e4m3
inputs (per-tensor scale) and accumulates in f32.
"""

from __future__ import annotations

import torch

from reference.tdnn import fp8_round


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fp8_round(x) @ fp8_round(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = fp8_round(g)
        gx = gq @ fp8_round(w).T
        gw = fp8_round(x).reshape(-1, x.shape[-1]).T @ gq.reshape(
            -1, g.shape[-1])
        return gx, gw


def _product(x, w, precision):
    if precision == "fp8":
        return _Fp8MatMul.apply(x.float(), w.float())
    return x @ w


def forward(params: dict, feats: torch.Tensor, splice_indexes,
            precision: str = "f64") -> torch.Tensor:
    """feats [N, T, D] -> log-posteriors [N, T - context, P]."""
    dt = torch.float64 if precision == "f64" else torch.float32
    x = feats.to(dt)
    for k, ctx in enumerate(splice_indexes):
        lo, hi = min(ctx), max(ctx)
        T = x.shape[1] - (hi - lo)
        sp = torch.cat([x[:, o - lo: o - lo + T] for o in ctx], dim=2)
        y = torch.relu(_product(sp, params[f"layers.{k}.w"], precision)
                       .to(dt) + params[f"layers.{k}.b"])
        x = y * torch.rsqrt((y * y).mean(dim=2, keepdim=True) + 1e-20)
    logits = _product(x, params["final.w"], precision).to(dt) \
        + params["final.b"]
    return torch.log_softmax(logits, dim=2)


def steps(params: dict, batches: list, splice_indexes, lrs: list,
          max_grad_norm: float, precision: str = "f64"):
    """Follow SGD steps from `params` over `batches` [(feats, targets,
    weights)] at rates `lrs`. -> (losses, params after each step)."""
    dt = torch.float64 if precision == "f64" else torch.float32
    p = {k: v.detach().to(dt).clone() for k, v in params.items()}
    losses, after = [], []
    for (feats, tgt, wts), lr in zip(batches, lrs):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        lp = forward(leaves, feats, splice_indexes, precision)
        ll = torch.gather(lp, 2, tgt.long()[..., None])[..., 0]
        w = wts.to(lp.dtype)
        loss = -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = 1.0 if norm < max_grad_norm else max_grad_norm / norm
            p = {k: v - lr * scale * g for (k, v), g in zip(p.items(), grads)}
        losses.append(float(loss.detach()))
        after.append(p)
    return losses, after
