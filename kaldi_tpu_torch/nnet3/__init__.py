"""Counterpart of kaldi_tpu.nnet3: declarative, config-defined
computation-graph nets (ref: src/nnet3: named nodes nnet3/nnet-nnet.h:81,
the Descriptor language nnet3/nnet-descriptor.h:41-54, config parsing
nnet3/nnet-parse.h:145). The reference compiles a computation
(nnet3/nnet-compile.h:44); here `Nnet3.forward` runs the node graph over
tensors, densely or in a loop over frames for recurrent configs.
"""

from kaldi_tpu_torch.nnet3.descriptors import Descriptor, parse_descriptor
from kaldi_tpu_torch.nnet3.network import Nnet3, parse_config

__all__ = ["Descriptor", "parse_descriptor", "Nnet3", "parse_config"]
