"""AmNnet: a TDNN + pdf priors, scoring for the hybrid decoder.

Counterpart of kaldi_tpu/nnet/am_nnet.py (ref: nnet2/am-nnet.h AmNnet —
pseudo-loglikes = log p(pdf|x) - log prior; nnet2bin/nnet-adjust-priors.cc
computes priors from average posteriors). The JAX class keeps a model and
a params pytree apart; here the `Tdnn` module holds its weights, and
`replace_params` builds a new module from the params it is given. The TDNN
runs in f32 on the module's device; priors stay numpy on the host, as in
the JAX class.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.nnet.combine import sum_group_log_posteriors
from kaldi_tpu_torch.nnet.tdnn import Tdnn
from kaldi_tpu_torch.params import tdnn_params_from_jax


class AmNnet:
    def __init__(self, model: Tdnn, priors: np.ndarray | None = None,
                 group_ids: np.ndarray | None = None,
                 lr_scales: dict | None = None):
        """group_ids: after nnet-am-mixup the final affine has M > C rows;
        group_ids [M] maps mixture rows back to pdf classes and posteriors
        are group-summed (ref: nnet2/mixup-nnet.h MixtureProbComponent).
        lr_scales: per-layer learning-rate factors, carried as data for a
        trainer."""
        self.model = model
        self.meta: dict = {}     # free-form metadata, as in the JAX class
        self.group_ids = (None if group_ids is None
                          else np.asarray(group_ids, np.int32))
        self.lr_scales = lr_scales
        n = self.num_pdfs if priors is None else len(np.asarray(priors))
        self.priors = (np.asarray(priors) if priors is not None
                       else np.ones(n) / n)

    @property
    def device(self) -> torch.device:
        """Where the TDNN's weights are, and so where it scores."""
        return next(self.model.parameters()).device

    @property
    def num_pdfs(self) -> int:
        if self.group_ids is not None:
            return int(self.group_ids.max()) + 1
        return self.model.config.num_pdfs

    @torch.inference_mode()
    def log_posteriors(self, feats, pad_context: bool = True) -> torch.Tensor:
        """feats [..., T, D] -> log p(pdf|x) [..., T, num_pdfs] on the
        model's device (group-summed over mixture rows if mixed up).
        pad_context=False for inputs that already carry the context."""
        x = torch.as_tensor(feats).to(device=self.device, dtype=torch.float32)
        log_post = self.model(x, pad_context=pad_context)
        if self.group_ids is not None:
            log_post = sum_group_log_posteriors(log_post, self.group_ids,
                                                self.num_pdfs)
        return log_post

    @torch.inference_mode()
    def loglikes(self, feats) -> torch.Tensor:
        """feats [..., T, D] -> pseudo-loglikes [..., T, num_pdfs]."""
        log_post = self.log_posteriors(feats)
        log_prior = torch.log(torch.as_tensor(
            np.maximum(self.priors, 1e-20), dtype=torch.float32,
            device=log_post.device))
        return log_post - log_prior

    def loglikes_np(self, feats, scale: float = 1.0) -> np.ndarray:
        return self.loglikes(feats).cpu().numpy() * scale

    def set_priors_from_posteriors(self, feats_batches):
        """nnet-adjust-priors: priors := average posterior over data."""
        acc = np.zeros(self.num_pdfs, np.float64)
        n = 0
        for feats in feats_batches:
            p = np.exp(self.log_posteriors(feats).cpu().numpy())
            acc += p.reshape(-1, self.num_pdfs).sum(axis=0)
            n += int(np.prod(p.shape[:-1]))
        self.priors = (acc / max(n, 1)).astype(np.float64)

    def replace_params(self, params) -> "AmNnet":
        """A new AmNnet over a new model holding `params`: a JAX Tdnn
        pytree with numpy leaves, or the port's own params dict ("layers.0.w"
        -> tensor). The model takes its widths from the params, so they may
        differ from this one's (widened, mixed up, a new output layer), as
        in the JAX class; priors, group_ids and lr_scales are shared and
        meta starts empty. A JAX tree's leaf order per layer is the file
        order the model is saved in (`leaf_order`, io/model_io.py)."""
        tree = "layers" in params
        flat = tdnn_params_from_jax(params) if tree else params
        model = Tdnn.from_params(self.model.config, flat,
                                 device=self.model.final.w.device)
        if tree:
            model.leaf_order = [list(layer) for layer in params["layers"]]
        return AmNnet(model, self.priors, group_ids=self.group_ids,
                      lr_scales=self.lr_scales)

    def set_priors_from_alignment_counts(self, counts: np.ndarray):
        c = np.asarray(counts, np.float64) + 0.5
        self.priors = c / c.sum()
