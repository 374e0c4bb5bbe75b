"""The acoustic model's weights, made by the benchmark: drawn on the
device from the configuration's seed, then trained by a plain PyTorch
loop on the configuration's synthetic training batch, so that the AM's
posteriors are peaky and the beam prunes as a deployed model's would
(random weights give flat posteriors, which fill the frontier).

The recipe is the JAX bench's (bench.py:173-198): cross-entropy over the
batch, bf16 products, the global gradient norm clipped at max_grad_norm,
SGD whose rate decays exponentially from initial_lr to final_lr over the
steps. Hidden layers start from N(0, 1/in) weights and N(0, 1) biases,
the final affine from zeros (nnet2's AffineComponent init). Splicing is
done with slices, so the backward pass adds no atomics and repeats.
Nothing of the program is imported.
"""

from __future__ import annotations

import torch


def init_weights(feat_dim: int, hidden_dim: int, num_pdfs: int,
                 splice_indexes, seed: int, device) -> dict:
    """{"layers.<k>.w" [in, out], "layers.<k>.b", "final.w", "final.b"}
    f32 on `device`, drawn from a generator there."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params, in_dim = {}, feat_dim
    for k, ctx in enumerate(splice_indexes):
        fan_in = in_dim * len(ctx)
        params[f"layers.{k}.w"] = torch.randn(
            (fan_in, hidden_dim), generator=gen, device=device) \
            / fan_in ** 0.5
        params[f"layers.{k}.b"] = torch.randn((hidden_dim,), generator=gen,
                                              device=device)
        in_dim = hidden_dim
    params["final.w"] = torch.zeros((in_dim, num_pdfs), device=device)
    params["final.b"] = torch.zeros((num_pdfs,), device=device)
    return params


def valid_forward(params: dict, feats: torch.Tensor, splice_indexes,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """feats [N, T, D] -> log-posteriors [N, T - context, P]: valid-mode
    splices by slicing, products in `dtype`, the rest in f32."""
    x = feats
    for k, ctx in enumerate(splice_indexes):
        lo, hi = min(ctx), max(ctx)
        T = x.shape[1] - (hi - lo)
        sp = torch.cat([x[:, o - lo: o - lo + T] for o in ctx], dim=2)
        y = (sp.to(dtype) @ params[f"layers.{k}.w"].to(dtype)).float() \
            + params[f"layers.{k}.b"]
        y = torch.relu(y)
        x = y * torch.rsqrt((y * y).mean(dim=2, keepdim=True) + 1e-20)
    logits = (x.to(dtype) @ params["final.w"].to(dtype)).float() \
        + params["final.b"]
    return torch.log_softmax(logits, dim=2)


def train(params: dict, feats: torch.Tensor, targets: torch.Tensor,
          splice_indexes, steps: int, initial_lr: float, final_lr: float,
          max_grad_norm: float) -> dict:
    """`steps` full-batch SGD steps on feats [N, T, D] and targets
    [N, T - context] (long). -> the trained params (new tensors)."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    for step in range(steps):
        lr = initial_lr * (final_lr / initial_lr) ** (step / steps)
        lp = valid_forward(p, feats, splice_indexes)
        loss = -torch.gather(lp, 2, targets[..., None]).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(max_grad_norm / (norm + 1e-30), max=1.0)
            for v, g in zip(p.values(), grads):
                v.sub_(lr * scale * g)
    return {k: v.detach() for k, v in p.items()}
