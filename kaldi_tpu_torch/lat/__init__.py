"""Lattice generation on the port (kaldi_tpu/lat counterparts): the
container, pruning and best path, raw-lattice extraction from the
decoder's records (numpy and native), and the text ark format."""
