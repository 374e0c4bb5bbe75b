"""Streaming recognition on tensors (kaldi_tpu/online counterparts)."""
