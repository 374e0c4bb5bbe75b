"""Lossy audio transport compression for the online server.

(ref: online2/online-speex-wrapper.h OnlineSpeexEncoder/Decoder — wraps
 libspeex to compress waveform chunks between the audio source and the
 decoder. Speex itself isn't in this image; the same role is played by
 G.711 µ-law (2:1, 8-bit) and IMA ADPCM (4:1, 4-bit) codecs — streaming,
 chunk-wise, with carried codec state like the reference's wrapper.)

The port's copy of kaldi_tpu/online/compress.py (host code).
"""

from __future__ import annotations

import numpy as np

_MU = 255.0


def mulaw_encode(wave: np.ndarray) -> np.ndarray:
    """float wave (int16 scale) -> uint8 µ-law codes."""
    x = np.clip(np.asarray(wave, np.float64) / 32768.0, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def mulaw_decode(codes: np.ndarray) -> np.ndarray:
    y = codes.astype(np.float64) / 127.5 - 1.0
    x = np.sign(y) * (np.expm1(np.abs(y) * np.log1p(_MU))) / _MU
    return (x * 32768.0).astype(np.float32)


_IMA_STEP = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)
_IMA_INDEX = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)


class AdpcmState:
    def __init__(self):
        self.predictor = 0
        self.index = 0


def adpcm_encode(wave: np.ndarray, state: AdpcmState | None = None):
    """float wave (int16 scale) -> (uint8 nibble codes, state). 4 bits per
    sample; the state carries across chunks (streaming contract)."""
    st = state or AdpcmState()
    x = np.clip(np.round(np.asarray(wave, np.float64)), -32768, 32767)
    codes = np.empty(len(x), np.uint8)
    pred, idx = st.predictor, st.index
    for i, s in enumerate(x):
        step = int(_IMA_STEP[idx])
        diff = int(s) - pred
        code = 0
        if diff < 0:
            code = 8
            diff = -diff
        if diff >= step:
            code |= 4
            diff -= step
        if diff >= step // 2:
            code |= 2
            diff -= step // 2
        if diff >= step // 4:
            code |= 1
        delta = step // 8 + ((code & 1) * (step // 4)
                             + ((code >> 1) & 1) * (step // 2)
                             + ((code >> 2) & 1) * step)
        pred += -delta if (code & 8) else delta
        pred = max(-32768, min(32767, pred))
        idx = max(0, min(88, idx + int(_IMA_INDEX[code & 7])))
        codes[i] = code
    st.predictor, st.index = pred, idx
    return codes, st


def adpcm_decode(codes: np.ndarray, state: AdpcmState | None = None):
    st = state or AdpcmState()
    out = np.empty(len(codes), np.float32)
    pred, idx = st.predictor, st.index
    for i, code in enumerate(codes):
        code = int(code)
        step = int(_IMA_STEP[idx])
        delta = step // 8 + ((code & 1) * (step // 4)
                             + ((code >> 1) & 1) * (step // 2)
                             + ((code >> 2) & 1) * step)
        pred += -delta if (code & 8) else delta
        pred = max(-32768, min(32767, pred))
        idx = max(0, min(88, idx + int(_IMA_INDEX[code & 7])))
        out[i] = pred
    st.predictor, st.index = pred, idx
    return out, st
