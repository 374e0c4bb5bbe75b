"""Counterpart of kaldi_tpu.steps: the training drivers ported so far."""
