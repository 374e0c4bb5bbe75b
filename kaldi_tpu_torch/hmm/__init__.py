"""Host copies of kaldi_tpu.hmm (numpy): HMM topology and transition model."""
