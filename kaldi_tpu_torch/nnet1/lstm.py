"""Projected LSTM / BLSTM as a loop over frames.

Counterpart of kaldi_tpu/nnet1/lstm.py (ref:
nnet/nnet-lstm-projected-streams.h LstmProjectedStreams, the projected
LSTM of Sak et al. 2014: cell dim C, recurrent projection R < C fed back
into the gates, optional peepholes, parallel streams with carried state;
nnet/nnet-blstm-projected-streams.h for the bidirectional variant). The
input contributions of all frames are one GEMM; the recurrence is a
Python loop over frames where JAX has a `lax.scan`, with autograd through
it for training.

A layer's params are JAX's dict (w_gifo_x [4C, D], w_gifo_r [4C, R], bias
[4C], w_r_m [R, C], peep_i / peep_f / peep_o [C]). `LstmProjected` keeps
its params in a flat dict named by JAX's tree path ("layers.0.fwd.w_gifo_x",
"out_w"; `params.lstm_params_from_jax`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device


@dataclasses.dataclass
class LstmConfig:
    input_dim: int
    cell_dim: int
    proj_dim: int
    with_peepholes: bool = True


def _normal(generator, shape, device):
    gdev = generator.device if generator is not None else None
    return torch.randn(shape, generator=generator, device=gdev).to(device)


def lstm_init(generator: torch.Generator | None, cfg: LstmConfig,
              device=None) -> dict[str, torch.Tensor]:
    """JAX's init stddevs (its draws are not reproduced): gate weights
    1/sqrt(D + R), projection 1/sqrt(C), peepholes i and f 0.1; biases and
    peep_o zero. Drawn in JAX's key order."""
    C, R, D = cfg.cell_dim, cfg.proj_dim, cfg.input_dim
    s = 1.0 / np.sqrt(D + R)
    params = {
        "w_gifo_x": float(s) * _normal(generator, (4 * C, D), device),
        "w_gifo_r": float(s) * _normal(generator, (4 * C, R), device),
        "bias": torch.zeros(4 * C, device=device),
        "w_r_m": float(1.0 / np.sqrt(C)) * _normal(generator, (R, C),
                                                  device),
    }
    if cfg.with_peepholes:
        params["peep_i"] = 0.1 * _normal(generator, (C,), device)
        params["peep_f"] = 0.1 * _normal(generator, (C,), device)
        params["peep_o"] = torch.zeros(C, device=device)
    return params


def lstm_apply(params: dict, x: torch.Tensor, cfg: LstmConfig, state=None):
    """x [B, T, D] -> (y [B, T, R], final state (c [B, C], r [B, R])).

    state: the carried (c, r) for truncated BPTT across chunks (ref:
    LstmProjectedStreams::ResetStreams / stream state carrying)."""
    B, T, _D = x.shape
    C, R = cfg.cell_dim, cfg.proj_dim
    if state is None:
        state = (x.new_zeros((B, C)), x.new_zeros((B, R)))
    c, r = state
    # the input contributions of all frames: one GEMM
    xg = torch.matmul(x, params["w_gifo_x"].T) + params["bias"]  # [B, T, 4C]
    w_r = params["w_gifo_r"].T
    ys = []
    for t in range(T):
        gates = xg[:, t] + torch.matmul(r, w_r)                  # [B, 4C]
        g, i, f, o = torch.split(gates, C, dim=-1)
        if cfg.with_peepholes:
            i = i + c * params["peep_i"]
            f = f + c * params["peep_f"]
        g = torch.tanh(g)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        c = f * c + i * g
        if cfg.with_peepholes:
            o = o + c * params["peep_o"]
        o = torch.sigmoid(o)
        m = o * torch.tanh(c)
        r = torch.matmul(m, params["w_r_m"].T)                   # projection
        ys.append(r)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((B, 0, R))
    return y, (c, r)


def blstm_apply(fwd_params: dict, bwd_params: dict, x: torch.Tensor,
                cfg: LstmConfig) -> torch.Tensor:
    """Bidirectional: concat(forward LSTM, time-reversed backward LSTM)
    -> [B, T, 2R] (ref: nnet/nnet-blstm-projected-streams.h)."""
    yf, _ = lstm_apply(fwd_params, x, cfg)
    yb, _ = lstm_apply(bwd_params, x.flip(1), cfg)
    return torch.cat([yf, yb.flip(1)], dim=-1)


class LstmProjected:
    """LSTM-projected stack + softmax output (an nnet1 'Nnet'). `init`
    puts its params on `device`; `apply` runs where the params are."""

    def __init__(self, cfg: LstmConfig, num_pdfs: int, num_layers: int = 1,
                 bidirectional: bool = False, device="cuda"):
        self.cfg = cfg
        self.num_pdfs = num_pdfs
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator | None = None
             ) -> dict[str, torch.Tensor]:
        params = {}
        dim_in = self.cfg.input_dim
        dirs = ("fwd", "bwd") if self.bidirectional else ("fwd",)
        for li in range(self.num_layers):
            lcfg = dataclasses.replace(self.cfg, input_dim=dim_in)
            for d in dirs:
                for k, v in lstm_init(generator, lcfg, self.device).items():
                    params[f"layers.{li}.{d}.{k}"] = v
            dim_in = len(dirs) * self.cfg.proj_dim
        params["out_w"] = float(1.0 / np.sqrt(dim_in)) * _normal(
            generator, (self.num_pdfs, dim_in), self.device)
        params["out_b"] = torch.zeros(self.num_pdfs, device=self.device)
        return params

    def _layer(self, params: dict, li: int, d: str) -> dict:
        prefix = f"layers.{li}.{d}."
        return {k[len(prefix):]: v for k, v in params.items()
                if k.startswith(prefix)}

    def apply(self, params: dict, x: torch.Tensor, states=None):
        """-> (log-posteriors [B, T, P], new states: (c, r) per layer, None
        for a bidirectional one)."""
        new_states = []
        h = x
        for li in range(self.num_layers):
            lcfg = dataclasses.replace(self.cfg, input_dim=h.shape[-1])
            if self.bidirectional:
                h = blstm_apply(self._layer(params, li, "fwd"),
                                self._layer(params, li, "bwd"), h, lcfg)
                new_states.append(None)
            else:
                st = states[li] if states is not None else None
                h, st_new = lstm_apply(self._layer(params, li, "fwd"), h,
                                       lcfg, st)
                new_states.append(st_new)
        logits = torch.matmul(h, params["out_w"].T) + params["out_b"]
        return torch.log_softmax(logits, dim=-1), new_states
