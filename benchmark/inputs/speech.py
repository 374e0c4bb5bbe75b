"""The benchmark's synthetic 8 kHz speech for the speaker cells.

Frozen copies of `chip_smoke.py`'s `ladder_vocab`, `ladder_synth` and the
vocabulary, phone frequencies, speaker warps and tilts of `sre_corpus`
(each phone a raised-cosine glide between its neighbours' targets, an
amplitude tilt per speaker, white noise), and of `sre_mfcc_opts` as plain
options (`SRE_MFCC`: sre10's conf/mfcc.conf). `synth_side` is
`ladder_synth` computed for a whole conversation side at once on a
device (one pass over the samples instead of a loop over its thousands
of phones); without noise it agrees with `ladder_synth` to rounding.
"""

from __future__ import annotations

import numpy as np

SR = 8000.0

# sre10's conf/mfcc.conf (chip_smoke.sre_mfcc_opts): 8 kHz, 25 ms frames,
# 20 cepstra with energy, mel bins from 20 to 3700 Hz; no dither
SRE_MFCC = dict(samp_freq=SR, frame_length_ms=25.0, frame_shift_ms=10.0,
                dither=0.0, num_bins=23, low_freq=20.0, high_freq=3700.0,
                num_ceps=20, cepstral_lifter=22.0, use_energy=True)


def ladder_vocab(rng, n_words: int, n_phones: int = 30):
    """-> (lexicon text, words): words of 3-5 phones."""
    words = [f"W{k:03d}" for k in range(n_words)]
    lines = []
    for w in words:
        L = int(rng.randint(3, 6))
        seq = " ".join(f"P{rng.randint(n_phones)}" for _ in range(L))
        lines.append(f"{w} {seq}")
    return "\n".join(lines), words


def ladder_synth(phones, freqs, rng, warp, noise, coart, amp_tilt):
    """Each phone a raised-cosine glide between its neighbours' targets."""
    sr = SR
    targets = np.array([freqs[p] for p in phones]) * warp
    segs = [np.zeros(int(sr * rng.uniform(0.05, 0.1)))]
    n = len(targets)
    for i, f0 in enumerate(targets):
        dur = int(sr * rng.uniform(0.07, 0.14))
        prev_f = targets[i - 1] if i > 0 else f0
        next_f = targets[i + 1] if i + 1 < n else f0
        t = np.arange(dur) / dur
        a = coart / 2
        f_in = 0.5 * (prev_f + f0)
        f_out = 0.5 * (next_f + f0)
        freq = np.where(
            t < a, f_in + (f0 - f_in) * 0.5 * (1 - np.cos(np.pi * t / a)),
            np.where(t > 1 - a,
                     f0 + (f_out - f0) * 0.5 *
                     (1 - np.cos(np.pi * (t - (1 - a)) / a)),
                     f0))
        ph = np.cumsum(2 * np.pi * freq / sr)
        amp = 2200.0 * (1.0 + amp_tilt * (f0 / 3400.0 - 0.5))
        env = np.minimum(1.0, np.minimum(np.arange(dur), dur -
                                         np.arange(dur)) / (0.010 * sr))
        segs.append(np.sin(ph) * amp * env * rng.uniform(0.8, 1.0))
    segs.append(np.zeros(int(sr * rng.uniform(0.05, 0.1))))
    w = np.concatenate(segs)
    return (w + rng.randn(len(w)) * noise).astype(np.float32)


def synth_side(phones, freqs, rng, warp, noise, coart, amp_tilt,
               device="cpu"):
    """`ladder_synth` over a long phone sequence in one vectorized pass,
    the samples computed in f64 on `device`: -> f32 tensor there. The
    lead silence, each phone's duration and amplitude and the tail
    silence are drawn from `rng` in `ladder_synth`'s order; the noise
    comes from a torch generator on `device` seeded from `rng`. Without
    noise it agrees with `ladder_synth` to rounding."""
    import torch
    sr = SR
    targets = np.array([freqs[p] for p in phones]) * warp
    n = len(targets)
    lead = int(sr * rng.uniform(0.05, 0.1))
    u = rng.random_sample((n, 2))
    durs = (sr * (0.07 + (0.14 - 0.07) * u[:, 0])).astype(np.int64)
    ampf = 0.8 + (1.0 - 0.8) * u[:, 1]
    tail = int(sr * rng.uniform(0.05, 0.1))
    noise_seed = int(rng.randint(2 ** 31 - 1))

    def t64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    durs_t = torch.as_tensor(durs, device=device)
    seg = torch.repeat_interleave(torch.arange(n, device=device), durs_t)
    starts = torch.cumsum(durs_t, 0) - durs_t
    pos = (torch.arange(len(seg), device=device) - starts[seg]).double()
    dur = durs_t[seg].double()
    t = pos / dur
    tg = t64(targets)
    f0 = tg[seg]
    prev_f = torch.cat([tg[:1], tg[:-1]])[seg]
    next_f = torch.cat([tg[1:], tg[-1:]])[seg]
    a = coart / 2
    f_in = 0.5 * (prev_f + f0)
    f_out = 0.5 * (next_f + f0)
    freq = torch.where(
        t < a, f_in + (f0 - f_in) * 0.5 * (1 - torch.cos(np.pi * t / a)),
        torch.where(t > 1 - a,
                    f0 + (f_out - f0) * 0.5 *
                    (1 - torch.cos(np.pi * (t - (1 - a)) / a)),
                    f0))
    inc = 2 * np.pi * freq / sr
    cs = torch.cumsum(inc, 0)
    ph = cs - (cs[starts] - inc[starts])[seg]
    amp = 2200.0 * (1.0 + amp_tilt * (f0 / 3400.0 - 0.5))
    env = torch.clamp(torch.minimum(pos, dur - pos) / (0.010 * sr), max=1.0)
    body = torch.sin(ph) * amp * env * t64(ampf)[seg]
    w = torch.cat([torch.zeros(lead, dtype=torch.float64, device=device),
                   body,
                   torch.zeros(tail, dtype=torch.float64, device=device)])
    if noise:
        gen = torch.Generator(device=device)
        gen.manual_seed(noise_seed)
        w = w + noise * torch.randn(w.shape, generator=gen,
                                    dtype=torch.float64, device=device)
    return w.float()


class SpeakerPool:
    """`sre_corpus`'s vocabulary (120 words of 3-5 of 30 phones), phone
    target frequencies (mel-spaced, 300-3400 Hz) and per-speaker warps
    (uniform 0.88-1.12) and tilts (uniform -0.5-0.5), all drawn from one
    RandomState(seed)."""

    def __init__(self, seed: int, speakers: int, n_words: int = 120,
                 n_phones: int = 30):
        self.rng = np.random.RandomState(seed)
        lex_text, self.vocab = ladder_vocab(self.rng, n_words, n_phones)
        self.lexicon = {ln.split()[0]: [int(p[1:]) for p in ln.split()[1:]]
                        for ln in lex_text.splitlines()}
        mel = 1127.0 * np.log1p(np.array([300.0, 3400.0]) / 700.0)
        self.freqs = 700.0 * np.expm1(
            np.linspace(mel[0], mel[1], n_phones) / 1127.0)
        self.speakers = [f"s{k:03d}" for k in range(speakers)]
        self.warps = {s: self.rng.uniform(0.88, 1.12) for s in self.speakers}
        self.tilts = {s: self.rng.uniform(-0.5, 0.5) for s in self.speakers}

    def side(self, spk: str, seconds: float, noise: float = 70.0,
             coart: float = 0.6, device="cpu"):
        """One conversation side of about `seconds` of speech by `spk`:
        words drawn until their phones fill the time (a phone lasts 105 ms
        on average), synthesized by `synth_side` on `device`: -> f32
        tensor there."""
        n_phones = max(1, int(round(seconds / 0.105)))
        phones: list[int] = []
        while len(phones) < n_phones:
            w = self.vocab[self.rng.randint(len(self.vocab))]
            phones.extend(self.lexicon[w])
        return synth_side(phones[:n_phones], self.freqs, self.rng,
                          self.warps[spk], noise, coart, self.tilts[spk],
                          device)
