"""I/O layer: wave files, Kaldi-compatible ark/scp tables, HTK features.

The Table abstraction (ref: util/kaldi-table.h) is realized as plain Python
iterators/dicts over (key, ndarray) pairs; the on-disk format is
read/write-compatible with the reference's binary ark/scp so that features,
alignments, and lattices can be exchanged with it for differential testing.

The port's copy of kaldi_tpu/io/ (host code); model files
(`model_io`) load into the port's classes.
"""

from kaldi_tpu_torch.io.wave import read_wave, write_wave
from kaldi_tpu_torch.io.htk import read_htk
from kaldi_tpu_torch.io.kaldi_io import (
    read_ark,
    write_ark,
    read_scp,
    read_matrix_ark,
    write_matrix_ark,
    open_rspecifier,
    open_wspecifier,
)
