"""Single-stream fused streaming decoder: wave chunks in, words out, with
the whole per-chunk pipeline on the decoder's device.

Counterpart of kaldi_tpu/online/fused.py (ref:
online2/online-nnet2-decoding.h:67 SingleUtteranceNnet2Decoder and the
driving binary online2bin/online2-wav-nnet2-latgen-faster.cc). Per chunk:
the sample ring takes the chunk, fbank frames the ring, the feature ring
takes the new frames, the TDNN scores a window with `left_context` frames
of true history, and the search advances over the frames whose future
context exists; the frontier and the back-pointer arena stay on the
device across chunks. Two search engines share the front end: the
degree-tiered CSR expansion (`CsrBeamDecoder`, the production engine,
whose emitting rounds look up the acoustic scores through the
table-gather kernel) and the padded [S, E] expansion (`BeamSearchDecoder`).

Parity with offline decoding holds by construction, as in JAX: frames
depend only on their own sample window (snip-edges), the TDNN sees true
history and clamps only at the stream's edges, and the search runs the
offline decoders' per-frame programs, starting from the start state's
eps closure (computed once per decoder, reused by every `reset`).

What changes with the framework, as in the port's `FusedStreamingServer`
(of which this is the one-stream case): the counters that JAX passes into
its jitted step (v0, nf, nd, d0, total) stay host ints, so the ring roll,
the FIFO slice and the clamped scoring window are host-int slicing and
one index_select; the frame loop stops after the chunk's nd frames
instead of scanning all ndmax with a mask (the masked frames' records
are never read), and writes exactly those rows of the arena, which keeps
JAX's ndmax spare rows. The traceback runs on the host after one copy of
the arena's used rows, the frontier and the log-likelihood ring.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder
from kaldi_tpu_torch.decoder.csr_beam import BIG, CsrBeamDecoder, _make_rounds
from kaldi_tpu_torch.decoder.hostpack import fetch_host
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.online.endpoint import endpoint_detected
from kaldi_tpu_torch.ops.features import FbankOpts, fbank
from kaldi_tpu_torch.ops.window import num_frames


class FusedOnlineDecoder:
    """Streaming wave -> words with device-resident state; it runs on its
    decoder's device (and moves the AM's model there).

    am: AmNnet (priors folded in on the device); dec: CsrBeamDecoder or
    BeamSearchDecoder; feat_opts: fbank options (dither 0 and snip_edges
    for exact offline parity); chunk_samples: dispatch granularity, a
    multiple of the frame shift (2560 = 160 ms at 16 kHz); t_max: arena
    capacity in frames; computer: feature fn(wave, opts) -> [T, D];
    keep_loglikes: keep each decoded frame's unscaled log-likelihoods on
    the device for `get_lattice`."""

    def __init__(self, am, dec, feat_opts: FbankOpts,
                 chunk_samples: int = 2560, t_max: int = 2048,
                 computer=fbank, keep_loglikes: bool = False):
        fo = feat_opts.frame_opts
        if not fo.snip_edges:
            raise ValueError("fused streaming assumes snip-edges framing")
        if fo.dither != 0.0:
            raise ValueError("dither makes chunked features stochastic; "
                             "disable it for the streamed==offline parity "
                             "contract")
        self.shift = fo.window_shift
        self.wsize = fo.window_size
        if chunk_samples % self.shift:
            raise ValueError(f"chunk_samples {chunk_samples} is not a "
                             f"multiple of the frame shift {self.shift}")
        if getattr(am, "group_ids", None) is not None:
            raise ValueError("mixed-up AMs (group-summed posteriors) not "
                             "supported on the fused path; use "
                             "SingleUtteranceNnet2Decoder")
        self._is_csr = isinstance(dec, CsrBeamDecoder)
        if not self._is_csr and not isinstance(dec, BeamSearchDecoder):
            raise TypeError(f"dec must be a CsrBeamDecoder or a "
                            f"BeamSearchDecoder, got {type(dec)}")
        self.device = dec.device
        self.am = am
        self.model = am.model.to(self.device).eval()
        self.dec = dec
        self.feat_opts = feat_opts
        self.computer = computer
        self.C = chunk_samples
        self.F = chunk_samples // self.shift
        self.lead = -(-(self.wsize - self.shift) // self.shift)
        self.BUF = self.C + self.lead * self.shift
        cfg = self.model.config
        self.lc = cfg.left_context
        self.rc = cfg.right_context
        self.ndmax = self.F + self.rc
        self.M = self.F + self.lc + self.rc           # feature ring frames
        self.Mw = self.ndmax + self.lc + self.rc      # scoring window
        self.t_max = t_max
        self._keep_ll = bool(keep_loglikes)
        o = dec.opts
        self.K = int(o.max_active)
        self.R = 1 + int(o.eps_expansions)
        self._feat_dim = cfg.feat_dim
        # the log in f64, then f32, as the JAX decoder takes it
        self._log_prior = torch.as_tensor(
            np.log(np.maximum(np.asarray(am.priors), 1e-20)),
            dtype=torch.float32, device=self.device)
        if self._is_csr:
            t = dec.tabs
            self._final_np = t.final.cpu().numpy()
            self._kbits = max((self.K - 1).bit_length(), 1)
            self._kmask = (1 << self._kbits) - 1
            self._rounds = _make_rounds(
                t.srow, t.zrow, t.brow, t.zbrow, dec._hub_state_arr,
                t.hub_rows, t.hub_cost, t.hub_onehot, t.hub_gpdf, t.hub_pdf,
                t.hub_bounds, 1, self.K, int(o.expand_budget),
                int(o.eps_budget), float(o.beam), b_apr=t.b_apr)
        else:
            self._final_np = dec._final_np
            self._rounds = dec._rounds
        self._init_closure()
        self.reset()

    # ------------------------------------------------------ init closure

    @torch.no_grad()
    def _init_closure(self):
        """The start state's eps closure, once per decoder: the frontier
        every utterance starts from, and its records for the traceback."""
        K, dev = self.K, self.device
        st = torch.zeros((1, K), dtype=torch.int32, device=dev)
        sc = torch.full((1, K), float(BIG), dtype=torch.float32, device=dev)
        if self._is_csr:
            st[0, 0] = int(self.dec.csr.start)
            sc[0, 0] = 0.0
            eps_round = self._rounds[1]
            recs = []
            for _ in range(self.R - 1):
                st, sc, rec, _il, _o = eps_round(st, sc)
                recs.append(rec[0])
            self._init_records = [(r & self._kmask, r >> self._kbits)
                                  for r in fetch_host(recs)]
        else:
            st[0, 0] = int(self.dec.graph.start)
            sc[0, 0] = 0.0
            st, sc, recs = self._rounds[1](st, sc)
            host = fetch_host([x for r in recs for x in (r[2][0], r[3][0])])
            self._init_records = list(zip(host[0::2], host[1::2]))
        self._init_st, self._init_sc = st, sc

    # ------------------------------------------------------------- stream

    def reset(self):
        D, K, dev = self._feat_dim, self.K, self.device
        rows = self.t_max + self.ndmax     # JAX's ndmax spare rows
        self._buf = torch.zeros(self.BUF, dtype=torch.float32, device=dev)
        self._fifo = torch.zeros((self.M, D), dtype=torch.float32, device=dev)
        self._nhist = 0
        self._st, self._sc = self._init_st.clone(), self._init_sc.clone()
        if self._is_csr:
            self._arena = torch.zeros((rows, self.R, K), dtype=torch.int32,
                                      device=dev)
            self._ilar = torch.zeros((rows, K), dtype=torch.int32, device=dev)
        else:
            self._arena = torch.zeros((rows, self.R, 3, K),
                                      dtype=torch.int32, device=dev)
        self._llar = torch.zeros((rows if self._keep_ll else 1,
                                  self.am.num_pdfs), dtype=torch.float32,
                                 device=dev)
        self._staging = np.zeros(0, np.float32)
        self._samples = 0          # true samples accepted
        self._chunks = 0           # C-sized chunks dispatched
        self._frames = 0           # feature frames pushed to the ring
        self._decoded = 0          # frames consumed by the search
        self._finished = False

    @property
    def num_frames_decoded(self) -> int:
        return self._decoded

    @torch.no_grad()
    def _step(self, chunk: np.ndarray, nf: int, v0: int, nd: int, d0: int,
              total: int):
        C, M, dev = self.C, self.M, self.device
        # 1. sample ring: the newest C samples enter on the right
        self._buf = torch.cat([self._buf, torch.as_tensor(
            chunk, dtype=torch.float32, device=dev)])[C:]
        # 2. fbank over the ring (the frame grid stays aligned to absolute
        #    sample offsets because BUF % shift == 0); the new frames, in
        #    order from ring slot v0, enter the feature FIFO
        fr = self.computer(self._buf, self.feat_opts)             # [F, D]
        cat = torch.cat([self._fifo, torch.roll(fr, -v0, dims=0)])
        start = min(max(nf, 0), fr.shape[0])   # dynamic_slice's clamp
        self._fifo = cat[start:start + M]
        self._nhist = min(self._nhist + nf, M)
        if nd == 0:
            return
        # 3. the AM's window, frames [d0-lc, d0+ndmax-1+rc], clamped to the
        #    ring's history (== pad_context at the stream's true edges)
        gidx = d0 - self.lc + np.arange(self.Mw)
        fidx = np.minimum(np.maximum(gidx - total + M, M - self._nhist),
                          M - 1)
        window = self._fifo.index_select(0, torch.as_tensor(fidx,
                                                            device=dev))
        ll_raw = self.model(window, pad_context=False) - self._log_prior
        ll = ll_raw * float(self.dec.opts.acoustic_scale)      # [ndmax, P]
        # 4. token passing over the nd decodable frames
        st, sc = self._st, self._sc
        emit_round, eps_round = self._rounds
        blocks, ils = [], []
        for j in range(nd):
            if self._is_csr:
                st, sc, rec, il, _ovf = emit_round(st, sc, ll[j:j + 1])
                recs = [rec[0]]
                for _ in range(self.R - 1):
                    st, sc, rec, _il, _o = eps_round(st, sc)
                    recs.append(rec[0])
                ils.append(il[0])
                blocks.append(torch.stack(recs))                  # [R, K]
            else:
                st, sc, records = emit_round(st, sc, ll[j:j + 1])
                blocks.append(torch.stack([torch.stack([r[2][0], r[3][0],
                                                        r[4][0]])
                                           for r in records]))    # [R, 3, K]
        self._st, self._sc = st, sc
        self._arena[d0:d0 + nd] = torch.stack(blocks)
        if self._is_csr:
            self._ilar[d0:d0 + nd] = torch.stack(ils)
        if self._keep_ll:
            self._llar[d0:d0 + nd] = ll_raw[:nd]

    def _dispatch(self, chunk: np.ndarray, flush: bool):
        fed = (self._chunks + 1) * self.C
        # frames computable from the samples on the device after this
        # chunk (accept_waveform may stage more than one chunk's worth)
        total_now = num_frames(min(self._samples, fed),
                               self.feat_opts.frame_opts)
        nf = total_now - self._frames
        # ring slot of the first new frame (the slot grid is fed-sample
        # based)
        v0 = self._frames - (fed - self.BUF) // self.shift
        nd_end = total_now if flush else max(self._decoded,
                                             total_now - self.rc)
        nd = nd_end - self._decoded
        assert 0 <= nd <= self.ndmax and 0 <= v0 <= self.lead
        if nd_end > self.t_max:
            raise RuntimeError(f"utterance exceeds arena capacity "
                               f"t_max={self.t_max}")
        self._step(chunk, nf, v0, nd, self._decoded, total_now)
        self._chunks += 1
        self._frames = total_now
        self._decoded = nd_end

    def accept_waveform(self, wave: np.ndarray):
        if self._finished:
            raise ValueError("input already finished; reset() first")
        self._staging = np.concatenate(
            [self._staging, np.asarray(wave, np.float32)])
        self._samples += len(wave)
        while len(self._staging) >= self.C:
            self._dispatch(self._staging[:self.C], flush=False)
            self._staging = self._staging[self.C:]

    def input_finished(self):
        """Flush: pad the remainder to one chunk (frames never cover the
        padding: num_frames() of the true sample count gates them) and
        decode through the final frame with right-edge clamping."""
        if self._finished:
            raise ValueError("input already finished; reset() first")
        self._finished = True
        pad = np.zeros(self.C - len(self._staging), np.float32)
        self._dispatch(np.concatenate([self._staging, pad]), flush=True)
        self._staging = np.zeros(0, np.float32)

    def sync(self):
        """Block until every dispatched chunk has run (for latency
        measurement; the dispatches themselves do not wait)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ results

    def _frontier(self):
        st, sc = fetch_host([self._st[0], self._sc[0]])
        return st, sc

    def best_path(self, use_final_probs: bool = True):
        """-> (words, tids, cost) or None; a partial result when called
        before input_finished() (ref: lattice-faster-online-decoder.h
        BestPathIterator / GetBestPath)."""
        n = self._decoded
        if self._is_csr:
            st, sc, arena, ilar = fetch_host(
                [self._st[0], self._sc[0], self._arena[:n], self._ilar[:n]])
        else:
            st, sc, arena = fetch_host([self._st[0], self._sc[0],
                                        self._arena[:n]])
        costs = sc + self._final_np[st]
        use_f = use_final_probs and costs.min() < BIG / 2
        slot = int(np.argmin(costs) if use_f else np.argmin(sc))
        cost = float(costs.min() if use_f else sc.min())
        if not sc.min() < BIG / 2:
            return None
        words_rev, tids_rev = [], []
        for t in range(n - 1, -1, -1):
            if self._is_csr:
                ol = [0] * self.R
                for r in range(self.R - 1, 0, -1):
                    pr = int(arena[t, r, slot])
                    ol[r], slot = pr >> self._kbits, pr & self._kmask
                il = [int(ilar[t, slot])]
                pr = int(arena[t, 0, slot])
                ol[0], slot = pr >> self._kbits, pr & self._kmask
            else:
                ol, il = [0] * self.R, [0] * self.R
                for r in range(self.R - 1, -1, -1):
                    ol[r], il[r] = int(arena[t, r, 1, slot]), \
                        int(arena[t, r, 2, slot])
                    slot = int(arena[t, r, 0, slot])
            words_rev.extend(o for o in reversed(ol) if o)
            tids_rev.extend(i for i in reversed(il) if i)
        # init-closure tail (eps arcs out of the start state)
        for (pv, ol0) in reversed(self._init_records):
            o = int(ol0.reshape(-1)[slot])
            if o:
                words_rev.append(o)
            slot = int(pv.reshape(-1)[slot])
        return words_rev[::-1], tids_rev[::-1], cost

    def final_relative_cost(self) -> float:
        """(ref: lattice-faster-online-decoder FinalRelativeCost; feeds the
        endpointing rules)."""
        st, sc = self._frontier()
        best = sc.min()
        if best >= BIG / 2:
            return float("inf")
        return float((sc + self._final_np[st]).min() - best)

    def trailing_silence_frames(self, silence_phones: set,
                                trans_model) -> int:
        """Consecutive final frames whose best-path phone is silence
        (ref: online2/online-endpoint.h TrailingSilenceLength)."""
        res = self.best_path(use_final_probs=False)
        if res is None:
            return 0
        _w, tids, _c = res
        count = 0
        for tid in reversed(tids):
            if trans_model.transition_id_to_phone(tid) in silence_phones:
                count += 1
            else:
                break
        return count

    def endpoint_detected(self, config, silence_phones: set, trans_model,
                          frame_shift: float = 0.01) -> bool:
        """(ref: online2/online-endpoint.cc EndpointDetected over the fused
        decoder's partial state.)"""
        trailing = self.trailing_silence_frames(silence_phones, trans_model)
        return endpoint_detected(config, frame_shift, self._decoded,
                                 trailing, self.final_relative_cost())

    def get_lattice(self, lattice_beam: float = 8.0):
        """Raw lattice of the utterance so far (the reference's online
        GetLattice, ref: online2/online-nnet2-decoding.h:96): the offline
        record decode and extraction over the kept log-likelihoods, which
        equal the offline AM scores, so the lattice is the offline latgen
        lattice. Needs keep_loglikes=True."""
        if not self._keep_ll:
            raise ValueError("get_lattice needs a decoder built with "
                             "keep_loglikes=True")
        n = self._decoded
        if n == 0:
            return None
        ll = self._llar[:n].cpu().numpy()
        return decode_to_lattices(self.dec, ll[None], np.array([n], np.int32),
                                  lattice_beam)[0]
