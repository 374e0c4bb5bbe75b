"""Host copies of kaldi_tpu.fst (pure Python): the WFST algebra, L, H and
HCLG construction, and per-utterance training graphs."""
