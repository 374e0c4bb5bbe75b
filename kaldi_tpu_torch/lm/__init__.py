"""Host copy of kaldi_tpu.lm's ARPA reader and G construction."""
