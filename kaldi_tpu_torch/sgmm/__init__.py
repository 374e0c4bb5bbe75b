"""Subspace GMM acoustic models (SGMM2) on a device.

Counterpart of kaldi_tpu/sgmm (ref: src/sgmm2 — AmSgmm2 sgmm2/am-sgmm2.h,
EM estimation sgmm2/estimate-am-sgmm2.h:126,253; Povey et al., "The
subspace Gaussian mixture model", 2011), with the same exports.
"""

from kaldi_tpu_torch.sgmm.model import AmSgmm2, Sgmm2SpeakerState
from kaldi_tpu_torch.sgmm.estimate import (Sgmm2Accs, update_sgmm2,
                                           estimate_speaker_vector,
                                           train_sgmm2)

__all__ = ["AmSgmm2", "Sgmm2SpeakerState", "Sgmm2Accs", "update_sgmm2",
           "estimate_speaker_vector", "train_sgmm2"]
