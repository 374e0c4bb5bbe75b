"""Lattices on the port (kaldi_tpu/lat counterparts): the container, the
lattice algorithms (`functions.py`: forward-backward, pruning, best path,
determinization, n-best, LM composition), the posteriors of
discriminative training (`posteriors.py`), raw-lattice extraction from
the decoder's records (numpy and native), and the text ark format."""
