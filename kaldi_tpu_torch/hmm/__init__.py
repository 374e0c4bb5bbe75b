"""Host copies of kaldi_tpu.hmm (numpy): HMM topology, transition model and
the Posterior tools."""
