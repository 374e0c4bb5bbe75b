"""Counterpart of kaldi_tpu.transform (see the modules for what is ported)."""
