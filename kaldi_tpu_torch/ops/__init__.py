"""Counterpart of kaldi_tpu.ops (see the modules for what is ported)."""
