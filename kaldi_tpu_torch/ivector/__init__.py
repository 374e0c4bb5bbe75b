"""Speaker/language recognition stack (ref: src/ivector, the fork's
specialty): energy VAD, i-vector extractor (T-matrix factor analysis over a
UBM), PLDA scoring, EER metric, logistic regression.

Counterpart of kaldi_tpu.ivector: VAD, PLDA and the EER are host numpy; the
extractor keeps JAX's per-utterance numpy methods beside a batch path on a
device; logistic regression trains on a device."""

from kaldi_tpu_torch.ivector.vad import compute_vad, VadOpts
from kaldi_tpu_torch.ivector.extractor import IvectorExtractor, IvectorStats
from kaldi_tpu_torch.ivector.plda import Plda, PldaStats
from kaldi_tpu_torch.ivector.metrics import compute_eer
