"""Counterpart of kaldi_tpu.transform (see the modules for what is ported):
CMVN, LDA, MLLT, fMLLR and fMPE's composition (PR 8-9); raw fMLLR, basis
fMLLR, regression-tree fMLLR / MLLR, LVTLN and HLDA on a device."""
