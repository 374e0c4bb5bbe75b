"""Host copies of kaldi_tpu.gmm (numpy): the UBMs the i-vector extractor uses."""
