"""Host copies of kaldi_tpu.fst (pure Python): the WFST algebra, L, H,
N-phone context and HCLG construction, per-utterance training graphs, and
the flat-array pipeline over the native graph ops."""
