"""Gaussian-level posteriors for SGMM training (the gpost archive).

Counterpart of kaldi_tpu/sgmm/gpost.py (ref: sgmm2/am-sgmm2.h Sgmm2GauPost /
sgmm2bin/sgmm2-post-to-gpost.cc — per frame, the within-state component
posteriors [substates x selected gaussians] plus the gselect indices they
are restricted to). `compute_gpost` runs on the model's device, the
entries grouped by state as `Sgmm2Accs.accumulate` groups them, and comes
back to the host once per state; the archive's reader and writer (a
pickle of {utt: [frame -> [(state j, gselect [K], post [M, K] float32)]]})
are host copies.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from kaldi_tpu_torch.sgmm.estimate import state_entries, state_posteriors
from kaldi_tpu_torch.sgmm.model import AmSgmm2, Sgmm2SpeakerState


def compute_gpost(model: AmSgmm2, feats, state_post, num_gselect: int = 10,
                  spk: Sgmm2SpeakerState | None = None):
    """state_post[t] = [(state j, weight)] ->
    gpost[t] = [(j, gsel [K] int32, post [M_j, K] float32)], post scaled
    by the state weight (ref: sgmm2-post-to-gpost.cc main loop)."""
    x = model._x(feats)
    ent = state_entries(state_post, model.device)
    gsel = model.gselect(x, num_gselect)
    got = {}
    for s, e, _ge, post, _tot in state_posteriors(model, x, ent, gsel, spk,
                                                  chunked=False):
        for k, p in zip(e.cpu().numpy(), post.to(torch.float32).cpu().numpy()):
            got[int(k)] = (s, p)
    g = gsel.cpu().numpy().astype(np.int32)
    tt = ent[0].cpu().numpy()
    n = len(x) if isinstance(state_post, tuple) else len(state_post)
    out = [[] for _ in range(n)]
    for k in range(len(tt)):
        s, p = got[k]
        out[tt[k]].append((s, g[tt[k]], p))
    return out


def write_gpost_ark(path: str, gposts: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(gposts, f, protocol=pickle.HIGHEST_PROTOCOL)


def read_gpost_ark(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d.items()
