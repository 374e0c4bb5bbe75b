"""Counterpart of kaldi_tpu.utils (see the modules for what is ported)."""
