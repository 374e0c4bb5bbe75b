"""Host copy of kaldi_tpu.tree's context dependency (monophone)."""
