"""Host copies of kaldi_tpu.tree: context dependency, event maps, Gaussian
clustering and decision-tree building."""
