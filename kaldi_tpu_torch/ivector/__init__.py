"""Host copy of kaldi_tpu.ivector.extractor (numpy)."""
