"""The serving entry point: waveforms in, word sequences out.

`Recognizer` composes exactly what the JAX benchmark composes for its
decode (bench.py: `feats_of`, `am_scores`, `CsrBeamDecoder.decode`):
fbank -> per-utterance CMVN -> TDNN log-posteriors (bf16 GEMMs by
default) -> degree-tiered CSR beam search. Everything after the waveform
upload runs on `device`; the decoder's finisher makes the one
device->host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.nnet.tdnn import Tdnn
from kaldi_tpu_torch.ops.features import FbankOpts, cmvn, fbank
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts

# the serving pipeline's features: 40 log-mel bins, 16 kHz, no dither
SERVING_FBANK = FbankOpts(frame_opts=FrameOpts(samp_freq=16000.0, dither=0.0),
                          mel_opts=MelOpts(num_bins=40))


class Recognizer:
    """recognize(waves [B, S]) -> per utterance (words, tids, cost) or None.

    `tdnn` is moved to `device`; the graph is tier-packed there once.
    compute_dtype=None runs the TDNN in f32 (the parity tests' setting)."""

    def __init__(self, tdnn: Tdnn, graph: PackedGraph,
                 opts: CsrBeamOpts = CsrBeamOpts(), device="cpu",
                 compute_dtype: torch.dtype | None = torch.bfloat16):
        self.device = resolve_device(device)
        self.tdnn = tdnn.to(self.device).eval()
        self.decoder = CsrBeamDecoder(graph, opts, device=self.device)
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def loglikes(self, waves) -> torch.Tensor:
        """waves [B, S] (numpy or tensor) -> TDNN log-posteriors [B, T, P]
        on the device."""
        w = torch.as_tensor(waves).to(device=self.device,
                                      dtype=torch.float32)
        feats = cmvn(fbank(w, SERVING_FBANK))
        return self.tdnn(feats, pad_context=True,
                         compute_dtype=self.compute_dtype)

    @torch.inference_mode()
    def recognize(self, waves) -> list:
        ll = self.loglikes(waves)
        B, T, _P = ll.shape
        return self.decoder.decode(ll, np.full(B, T, np.int32))
