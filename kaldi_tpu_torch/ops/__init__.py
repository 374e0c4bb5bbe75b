"""Counterpart of kaldi_tpu.ops (see the modules for what is ported): the
feature kernels, re-exported under kaldi_tpu/ops/__init__.py's names."""

from kaldi_tpu_torch.ops.window import (
    FrameOpts,
    num_frames,
    feature_window,
    frame_signal,
    extract_windows,
)
from kaldi_tpu_torch.ops.mel import (MelOpts, mel_scale, inverse_mel_scale,
                                     mel_banks)
from kaldi_tpu_torch.ops.dct import dct_matrix, lifter_coeffs
from kaldi_tpu_torch.ops.features import (
    MfccOpts,
    FbankOpts,
    PlpOpts,
    SpectrogramOpts,
    mfcc,
    fbank,
    plp,
    spectrogram,
)
from kaldi_tpu_torch.ops.delta import (DeltaOpts, add_deltas, splice_frames,
                                       sliding_cmvn)
