"""PyTorch + CUDA port of kaldi_tpu's hybrid ASR serving path.

The JAX package `kaldi_tpu` is the reference; this package mirrors its
layout (`ops/`, `nnet/`, `decoder/`) and never imports jax. Its serving
entry point is `kaldi_tpu_torch.recognize.Recognizer`: fbank -> CMVN ->
TDNN -> degree-tiered CSR beam search. Hand-written kernels live in
`csrc/` and are built at first use.
"""
