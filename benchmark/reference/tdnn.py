"""Plain reference of the relu TDNN acoustic model (nnet2 multisplice,
steps/nnet2/train_multisplice_accel2.sh): each layer splices its input at
its frame offsets (frame indices clamped at the utterance edges), applies
an affine map, a relu and a renormalisation to unit RMS; a final affine and
a log-softmax give the log-posteriors. Weights are [in, out] tensors named
"layers.<k>.w", "layers.<k>.b", "final.w", "final.b". Plain PyTorch;
nothing of the program is imported.

`precision` selects the products: "f64" is the reference; "fp8" is the
control, one step below the bf16 products the configuration states: each
product's input and weight are rounded to float8 e4m3 with a per-tensor
scale (the largest magnitude mapped to 448), then multiplied in f32.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    x = x.float()
    s = FP8_MAX / torch.clamp(x.abs().max(), min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


def _product(x, w, precision):
    if precision == "fp8":
        return fp8_round(x) @ fp8_round(w)
    return x @ w


def splice(x: torch.Tensor, ctx) -> torch.Tensor:
    """x [T, D] -> [T, D * len(ctx)], frame indices clamped to [0, T)."""
    T = x.shape[0]
    t = torch.arange(T, device=x.device)
    return torch.cat([x[torch.clamp(t + o, 0, T - 1)] for o in ctx], dim=1)


def log_posteriors(feats: torch.Tensor, params: dict, splice_indexes,
                   precision: str = "f64") -> torch.Tensor:
    """feats [T, D] -> log-posteriors [T, num_pdfs], f64 for "f64", else
    f32."""
    dt = torch.float64 if precision == "f64" else torch.float32
    x = feats.to(dt)
    for k, ctx in enumerate(splice_indexes):
        w = params[f"layers.{k}.w"].to(dt)
        b = params[f"layers.{k}.b"].to(dt)
        x = torch.relu(_product(splice(x, ctx), w, precision).to(dt) + b)
        x = x * torch.rsqrt((x * x).mean(dim=1, keepdim=True) + 1e-20)
    logits = _product(x, params["final.w"].to(dt), precision).to(dt) \
        + params["final.b"].to(dt)
    return torch.log_softmax(logits, dim=1)
