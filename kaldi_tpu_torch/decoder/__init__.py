"""Counterpart of kaldi_tpu.decoder (see the modules for what is ported)."""

from kaldi_tpu_torch.decoder.graph_pack import (PackedGraph, pack_graph,
                                                pack_graphs)
from kaldi_tpu_torch.decoder.viterbi import viterbi_align, equal_align
from kaldi_tpu_torch.decoder.graph_pack import split_csr, eps_depth
from kaldi_tpu_torch.decoder.csr_beam import (CsrBeamDecoder, CsrBeamOpts,
                                              AdaptiveCsrBeamDecoder)
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.dense import (DenseViterbiDecoder,
                                           DenseDecoderOpts, make_decoder)
from kaldi_tpu_torch.decoder.biggraph import make_big_hclg, BigGraphConfig
