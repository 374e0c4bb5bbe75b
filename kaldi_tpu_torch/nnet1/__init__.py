"""Counterpart of kaldi_tpu.nnet1: recurrent acoustic models and RBM
pretraining (ref: src/nnet, Karel Vesely's framework: projected LSTM /
BLSTM multi-stream nets nnet/nnet-lstm-projected-streams.h, RBM
pretraining nnet/nnet-rbm.h, 1-D conv / pooling
nnet/nnet-convolutional-component.h, losses nnet/nnet-loss.h:59,112,
frame shuffling nnet/nnet-randomizer.h:66, trainers
nnetbin/nnet-train-{frmshuff,lstm-streams}.cc).
"""

from kaldi_tpu_torch.nnet1.lstm import (LstmConfig, LstmProjected,
                                        blstm_apply, lstm_apply, lstm_init)
from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
from kaldi_tpu_torch.nnet1.train import (FrameShuffler, StreamTrainOpts,
                                         mse_loss, train_lstm_streams,
                                         xent_loss)

__all__ = [
    "LstmProjected", "LstmConfig", "lstm_init", "lstm_apply", "blstm_apply",
    "Rbm", "RbmConfig",
    "train_lstm_streams", "StreamTrainOpts", "xent_loss", "mse_loss",
    "FrameShuffler",
]
