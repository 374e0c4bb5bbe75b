"""Counterpart of kaldi_tpu.nnet (see the modules for what is ported)."""
