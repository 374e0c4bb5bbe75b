"""Mixture-component posteriors summed back to pdf classes.

Counterpart of kaldi_tpu/nnet/combine.py `sum_group_log_posteriors` (ref:
nnet2/mixup-nnet.h MixtureProbComponent). The rest of that module (model
averaging, mixing up) belongs to training and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def sum_group_log_posteriors(log_post: torch.Tensor, group_ids,
                             num_groups: int) -> torch.Tensor:
    """[..., M] mixed-up log-posteriors -> [..., C] by log-sum-exp over
    each group: a segment max shift, then a segment sum of exp."""
    gid = torch.as_tensor(np.asarray(group_ids), dtype=torch.int64,
                          device=log_post.device)
    shape = log_post.shape[:-1] + (num_groups,)
    idx = gid.expand_as(log_post)
    m = torch.full(shape, float("-inf"), dtype=log_post.dtype,
                   device=log_post.device)
    m = m.scatter_reduce(-1, idx, log_post, reduce="amax", include_self=True)
    shifted = torch.exp(log_post - m.index_select(-1, gid))
    s = torch.zeros(shape, dtype=log_post.dtype, device=log_post.device)
    s = s.index_add(-1, gid, shifted)
    return m + torch.log(torch.clamp(s, min=1e-37))
