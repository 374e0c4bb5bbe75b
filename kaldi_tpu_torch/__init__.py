"""PyTorch + CUDA port of kaldi_tpu's hybrid ASR serving and training paths.

The JAX package `kaldi_tpu` is the reference; this package mirrors its
layout (`ops/`, `nnet/`, `decoder/`, `lat/`, `utils/`) and never imports
jax. Its serving entry point is `kaldi_tpu_torch.recognize.Recognizer`:
fbank -> CMVN -> TDNN -> degree-tiered CSR beam search; the TDNN trains
with `nnet.train.make_train_step`. Hand-written kernels live in `csrc/`
and are built at first use.
"""

__version__ = "0.2.0"       # kaldi_tpu's, whose file formats it reads
