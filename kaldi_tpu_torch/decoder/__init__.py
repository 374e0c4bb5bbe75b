"""Counterpart of kaldi_tpu.decoder (see the modules for what is ported)."""
