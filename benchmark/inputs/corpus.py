"""The benchmark's synthetic speech: utterances sampled FROM the decoding
graph, so that a briefly trained AM gives peaky posteriors and the beam
prunes as it would on real speech.

Frozen copies of `kaldi_tpu_torch/decoder/simulate.py`: `_arc_sampler`,
`sample_path` (a random walk of the graph with arc probabilities
exp(-cost)), `ToneCoder` and `synth_wave` (a mel-spaced chord per pdf,
continuous phase, white noise) and `fbank_targets` (pdfs aligned to fbank
frames), reading the arrays of `inputs/graph.py`. `make_utterances` is
the program's `make_corpus` with one length per utterance.
"""

from __future__ import annotations

import numpy as np

BIG = 1e9


def _arc_sampler(graph: dict):
    """Per-state cached CDF sampler over exp(-cost)."""
    cache: dict[int, tuple[np.ndarray, int]] = {}
    arc_start = graph["arc_start"]
    cost = graph["cost"]

    def sample(s: int, rng) -> int:
        ent = cache.get(s)
        if ent is None:
            a0, a1 = int(arc_start[s]), int(arc_start[s + 1])
            if a1 == a0:
                cache[s] = (None, a0)
                return -1
            w = np.exp(-np.minimum(cost[a0:a1], 50.0).astype(np.float64))
            cdf = np.cumsum(w)
            cdf /= cdf[-1]
            ent = (cdf, a0)
            cache[s] = ent
        cdf, a0 = ent
        if cdf is None:
            return -1
        return a0 + int(np.searchsorted(cdf, rng.random()))

    return sample


def sample_path(graph: dict, T: int, rng,
                sampler=None):
    """Random-walk T emitting steps from the start state.

    -> (pdfs [T] int32, tids [T] int32, words list[int]) — the aligned
    pdf per frame, the transition-id per frame, and the olabel sequence.
    """
    sampler = sampler or _arc_sampler(graph)
    pdfs = np.zeros(T, np.int32)
    tids = np.zeros(T, np.int32)
    words: list[int] = []
    s = int(graph["start"])
    t = 0
    eps_guard = 0
    while t < T:
        a = sampler(s, rng)
        if a < 0:   # dead end: restart the walk from the start state
            s = int(graph["start"])
            eps_guard += 1
            if eps_guard > 10:
                raise ValueError("graph walk stuck (no outgoing arcs)")
            continue
        ol = int(graph["olabel"][a])
        if ol > 0:
            words.append(ol)
        p = int(graph["pdf"][a]) 
        if int(graph["ilabel"][a]) > 0:
            pdfs[t] = max(p, 0)
            tids[t] = int(graph["ilabel"][a])
            t += 1
            eps_guard = 0
        else:
            eps_guard += 1
            if eps_guard > 20:
                raise ValueError("eps cycle during graph walk")
        s = int(graph["nextstate"][a])
    return pdfs, tids, words


def _mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def _imel(m):
    return 700.0 * np.expm1(np.asarray(m, np.float64) / 1127.0)


class ToneCoder:
    """pdf -> 3- or 4-tone chord, grid points mel-spaced so a 40-bin
    fbank resolves every used pdf.

    Bands (f1, f2, f3) get (ceil(n/24), 6, 4) grid values over
    200-1500 / 1800-3900 / 4300-7500 Hz — mel spans of ~17 / ~8 / ~5
    fbank bins, so up to ~400 distinct pdfs stay >=1 bin apart in at
    least one band coordinate."""

    def __init__(self, used_pdfs: np.ndarray, samp_freq: float = 16000.0):
        used = np.unique(np.asarray(used_pdfs, np.int64))
        used = used[used >= 0]
        n = max(len(used), 1)
        if n <= 24 * 6 * 4:
            # 3-band layout (bit-compatible with the original corpus)
            n3, n2 = 4, 6
            n1 = -(-n // (n2 * n3))
            f1s = _imel(np.linspace(_mel(200.0), _mel(1500.0),
                                    max(n1, 2)))
            f2s = _imel(np.linspace(_mel(1800.0), _mel(3900.0), n2))
            f3s = _imel(np.linspace(_mel(4300.0), _mel(7500.0), n3))
            idx = np.arange(n)
            self.freqs = np.stack([
                f1s[idx // (n2 * n3)],
                f2s[(idx // n3) % n2],
                f3s[idx % n3],
            ], axis=1)                               # [n, 3]
        else:
            # 4-band layout for big tied-state inventories (e.g. ~5k
            # triphone senones): grids (16, 8, 7, 6) = 5376 chords over
            # 200-1200 / 1400-2800 / 3000-4800 / 5000-7600 Hz — each
            # band's values stay ~1 fbank bin apart, so a 40-bin fbank
            # still resolves every used pdf
            n4, n3, n2 = 6, 7, 8
            n1 = -(-n // (n2 * n3 * n4))
            if n1 > 16:
                raise ValueError(f"{n} distinct pdfs exceed the "
                                 f"tone-grid capacity "
                                 f"({16 * n2 * n3 * n4})")
            f1s = _imel(np.linspace(_mel(200.0), _mel(1200.0),
                                    max(n1, 2)))
            f2s = _imel(np.linspace(_mel(1400.0), _mel(2800.0), n2))
            f3s = _imel(np.linspace(_mel(3000.0), _mel(4800.0), n3))
            f4s = _imel(np.linspace(_mel(5000.0), _mel(7600.0), n4))
            idx = np.arange(n)
            self.freqs = np.stack([
                f1s[idx // (n2 * n3 * n4)],
                f2s[(idx // (n3 * n4)) % n2],
                f3s[(idx // n4) % n3],
                f4s[idx % n4],
            ], axis=1)                               # [n, 4]
        # dense index per pdf id (lookup table over the pdf id space)
        self.pdf_to_idx = np.zeros(int(used.max()) + 1 if n else 1,
                                   np.int64)
        self.pdf_to_idx[used] = idx[: len(used)]
        self.samp_freq = samp_freq


def synth_wave(pdfs: np.ndarray, rng, coder: ToneCoder,
               frame_shift: int = 160, noise: float = 0.1,
               amplitude: float = 3000.0) -> np.ndarray:
    """Mel-grid 3-tone chord per frame, continuous phase + white noise."""
    T = len(pdfs)
    f = coder.freqs[coder.pdf_to_idx[pdfs]]          # [T, n_bands]
    inst = np.repeat(f, frame_shift, axis=0)         # [T*shift, n_bands]
    ph = np.cumsum(2 * np.pi * inst / coder.samp_freq, axis=0)
    w = np.sin(ph).sum(axis=1) / f.shape[1]
    w = w + noise * rng.standard_normal(T * frame_shift)
    return (amplitude * w).astype(np.float32)


def fbank_targets(pdfs: np.ndarray, num_fbank_frames: int) -> np.ndarray:
    """Align per-segment pdfs to fbank frames: frame t's 25ms window is
    centered at sample t*160 + 200, i.e. segment t+1 (snip_edges)."""
    T = len(pdfs)
    idx = np.minimum(np.arange(num_fbank_frames) + 1, T - 1)
    return pdfs[idx].astype(np.int32)


def make_utterances(graph: dict, frames: list[int], rng, noise: float = 0.25,
                    coder: ToneCoder | None = None):
    """One utterance per entry of `frames` (its length in 10 ms segments):
    -> (waves [list of [frames * 160] f32], pdf segments [list of [frames]
    int32], word lists). `make_corpus` with a length per utterance."""
    sampler = _arc_sampler(graph)
    coder = coder or ToneCoder(graph["pdf"][graph["pdf"] >= 0])
    waves, segs, words = [], [], []
    for T in frames:
        pdfs, _tids, ws = sample_path(graph, int(T), rng, sampler)
        segs.append(pdfs)
        waves.append(synth_wave(pdfs, rng, coder, noise=noise))
        words.append(ws)
    return waves, segs, words


def lognormal_frames(n: int, median_s: float, sigma: float, lo_s: float,
                     hi_s: float) -> np.ndarray:
    """n utterance lengths in 10 ms segments: the (i + 0.5) / n quantiles
    of a log-normal duration (median `median_s`, log-sd `sigma`) clipped to
    [lo_s, hi_s]. Every seed gets this same set; only their order and
    content change."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    secs = np.clip(median_s * np.exp(sigma * z), lo_s, hi_s)
    return np.round(secs * 100).astype(np.int64)
