"""Counterpart of kaldi_tpu.utils (see the modules for what is ported)."""

from kaldi_tpu_torch.utils.wer import (levenshtein_alignment, compute_wer,
                                       WerStats)
