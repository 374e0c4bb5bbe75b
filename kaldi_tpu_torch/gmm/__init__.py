"""Counterpart of kaldi_tpu.gmm: host copies of the GMMs (numpy), and the
acoustic model (`am_gmm.py`) and statistics (`estimation.py`) with their
device parts in torch."""
