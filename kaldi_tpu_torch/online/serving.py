"""Batched streaming ASR serving: N concurrent streams advanced in lockstep.

Counterpart of kaldi_tpu/online/serving.py `FusedStreamingServer` (ref:
the reference serves live streams with one decoder process per stream,
online2bin/online2-tcp-nnet3-decode-faster.cc). All active streams advance
together once per chunk interval: framing, fbank, TDNN scoring and
degree-tiered token passing batched over streams, with the per-stream
state (sample ring, feature ring, frontier, back-pointer arena) resident
on the decoder's device. Each stream's hypothesis equals the offline
decode of the same wave (fbank -> AmNnet.loglikes -> CsrBeamDecoder).

What changes with the framework: the JAX server's `vmap` over slots is a
batch dimension (one fbank over [N, BUF], batched gathers for the ring
roll, the FIFO slice and the window, one TDNN forward over [N, Mw, D]);
its `lax.scan` over frames is a Python loop over the decoder's
`_make_rounds` with B = n_streams, which stops after the most frames any
slot decodes this step (the JAX scan runs all ndmax frames, and the
frames past a slot's count are masked no-ops whose records are never
read). Slot resets and the arena / il-array writes at each slot's d0
update the device-resident carry in place. The host keeps the per-slot
counters (v0, nf, nd, d0, total) exactly as the JAX server computes them.

With keep_loglikes=True the server also keeps each stream's unscaled
log-likelihoods in a device ring, written at each slot's d0 like the
arena, and `get_lattice` runs the offline latgen (lat.generate) over
them.

With `mesh=` (a parallel.mesh DeviceMesh) the streams shard over
`mesh_axis`, SPMD: every rank makes the same calls, so the host
bookkeeping (free list, staging, counters) is the same on every rank;
slot s lives on the rank at coordinate s // (n_streams / D) of the axis,
whose device carry and `step()` cover only its own slots. `best_path`
and `get_lattice` of slot s run on its owner and are broadcast over the
axis, so every rank returns the same answer.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.decoder.csr_beam import (_HALF_BIG, BIG,
                                              CsrBeamDecoder, _make_rounds)
from kaldi_tpu_torch.decoder.hostpack import fetch_host
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.ops.features import FbankOpts, fbank
from kaldi_tpu_torch.ops.window import num_frames
from kaldi_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                           broadcast_object, check_mesh)


class FusedStreamingServer:
    """Slot-based streaming server over one device-resident batch. It runs
    on its decoder's device.

    Usage:
        srv = FusedStreamingServer(am, dec, fb_opts, n_streams=16)
        s = srv.open()                  # -> slot id (None if full)
        srv.feed(s, samples)            # stage audio (any size)
        srv.input_finished(s)           # end of utterance
        srv.step()                      # advance all slots with a chunk
                                        #   staged or flushing
        if srv.finished(s):
            words, tids, cost = srv.best_path(s)
            srv.close(s)
    """

    def __init__(self, am, dec: CsrBeamDecoder, feat_opts: FbankOpts,
                 n_streams: int = 8, chunk_samples: int = 2560,
                 t_max: int = 1024, computer=fbank,
                 keep_loglikes: bool = False, mesh=None,
                 mesh_axis: str = "data"):
        if not isinstance(dec, CsrBeamDecoder):
            raise TypeError(f"dec must be a CsrBeamDecoder, got {type(dec)}")
        fo = feat_opts.frame_opts
        if not fo.snip_edges or fo.dither != 0.0:
            raise ValueError("streaming needs snip_edges=True and dither=0")
        if getattr(am, "group_ids", None) is not None:
            raise ValueError("mixed-up AMs (group_ids) are not served")
        self.shift = fo.window_shift
        self.wsize = fo.window_size
        if chunk_samples % self.shift:
            raise ValueError(f"chunk_samples {chunk_samples} is not a "
                             f"multiple of the frame shift {self.shift}")
        self.device = dec.device
        self.am = am
        self.model = am.model.to(self.device).eval()
        self.dec = dec
        self.feat_opts = feat_opts
        self.computer = computer
        self.N = n_streams
        self._mesh, self._axis = mesh, mesh_axis
        D = 1 if mesh is None else axis_size(check_mesh(mesh), mesh_axis)
        if n_streams % D:
            raise ValueError(f"n_streams {n_streams} does not split over "
                             f"{mesh_axis}={D}")
        self._nl = n_streams // D        # slots on this rank's device
        self._coord = 0 if mesh is None else axis_index(mesh, mesh_axis)
        self._lo = self._coord * self._nl  # its first slot
        self.C = chunk_samples
        self.F = chunk_samples // self.shift
        self.lead = -(-(self.wsize - self.shift) // self.shift)
        self.BUF = self.C + self.lead * self.shift
        cfg = self.model.config
        self.lc = cfg.left_context
        self.rc = cfg.right_context
        self.ndmax = self.F + self.rc
        self.M = self.F + self.lc + self.rc
        self.Mw = self.ndmax + self.lc + self.rc
        self.t_max = t_max
        self._keep_ll = bool(keep_loglikes)
        o = dec.opts
        self.K = int(o.max_active)
        self.R = 1 + int(o.eps_expansions)
        self._kbits = max((self.K - 1).bit_length(), 1)
        self._kmask = (1 << self._kbits) - 1
        self._feat_dim = cfg.feat_dim
        # the log in f64, then f32, as the JAX server takes it
        # (AmNnet.loglikes takes it in f32)
        self._log_prior = torch.as_tensor(
            np.log(np.maximum(np.asarray(am.priors), 1e-20)),
            dtype=torch.float32, device=self.device)
        self._rounds = self._rounds_for(self._nl)
        self._self_prev = torch.arange(
            self.K, dtype=torch.int32,
            device=self.device)[None, :].expand(self._nl, self.K)
        self._init_frontier()
        self._reset_all()

    # ------------------------------------------------------------ device

    def _rounds_for(self, B: int):
        o, t = self.dec.opts, self.dec.tabs
        return _make_rounds(
            t.srow, t.zrow, t.brow, t.zbrow, self.dec._hub_state_arr,
            t.hub_rows, t.hub_cost, t.hub_onehot, t.hub_gpdf, t.hub_pdf,
            t.hub_bounds, B, self.K, int(o.expand_budget), int(o.eps_budget),
            float(o.beam), b_apr=t.b_apr)

    @torch.no_grad()
    def _init_frontier(self):
        """The start state's eps closure, once: the frontier every slot
        starts from, and its records for best_path's host-side walk."""
        K, dev = self.K, self.device
        st = torch.zeros((1, K), dtype=torch.int32, device=dev)
        st[0, 0] = int(self.dec.csr.start)
        sc = torch.full((1, K), float(BIG), dtype=torch.float32, device=dev)
        sc[0, 0] = 0.0
        _emit, eps_round = self._rounds_for(1)
        recs = []
        for _ in range(self.R - 1):
            st, sc, rec, _il, _o = eps_round(st, sc)
            recs.append(rec[0])
        self._init_st, self._init_sc = st[0], sc[0]
        self._init_records = [(r & self._kmask, r >> self._kbits)
                              for r in (fetch_host(recs) if recs else [])]

    def _reset_all(self):
        N, D, K, dev = self._nl, self._feat_dim, self.K, self.device
        rows = self.t_max + self.ndmax
        self._buf = torch.zeros((N, self.BUF), dtype=torch.float32,
                                device=dev)
        self._fifo = torch.zeros((N, self.M, D), dtype=torch.float32,
                                 device=dev)
        self._nhist = torch.zeros(N, dtype=torch.int64, device=dev)
        self._st = self._init_st[None].expand(N, K).clone()
        self._sc = self._init_sc[None].expand(N, K).clone()
        # padded by ndmax rows: each step writes a fixed block of rows at
        # every slot's d0 (idle in-use slots write identity records there),
        # so without the pad a stream near capacity would have its tail
        # overwritten. Pad rows are never read.
        self._arena = torch.zeros((N, rows, self.R, K), dtype=torch.int32,
                                  device=dev)
        self._ilar = torch.zeros((N, rows, K), dtype=torch.int32, device=dev)
        # unscaled loglikes for get_lattice, padded like the arena
        self._llar = torch.zeros((N, rows if self._keep_ll else 1,
                                  self.am.num_pdfs), dtype=torch.float32,
                                 device=dev)
        N = self.N                      # the host's bookkeeping: every slot
        self._free = list(range(N))
        self._stage = [np.zeros(0, np.float32) for _ in range(N)]
        self._samples = np.zeros(N, np.int64)
        self._chunks = np.zeros(N, np.int64)
        self._frames = np.zeros(N, np.int64)
        self._decoded = np.zeros(N, np.int64)
        self._want_flush = np.zeros(N, bool)
        self._flushed = np.zeros(N, bool)
        self._pending_reset = np.zeros(N, bool)
        self._in_use = np.zeros(N, bool)

    @torch.no_grad()
    def _dispatch(self, chunks: torch.Tensor, ctrl: torch.Tensor,
                  n_frames: int):
        """One lockstep step of this device's N slots. ctrl [7, N] int64
        rows: active, reset, nf, v0, nd, d0, total. n_frames = max(nd)."""
        N, C, F, M, Mw, D = chunks.shape[0], self.C, self.F, self.M, \
            self.Mw, self._feat_dim
        dev = self.device
        active, reset = ctrl[0].bool(), ctrl[1].bool()
        nf, v0, nd, d0, total = ctrl[2], ctrl[3], ctrl[4], ctrl[5], ctrl[6]
        # slot reuse: re-initialise reset slots, in place
        self._buf.masked_fill_(reset[:, None], 0.0)
        self._fifo.masked_fill_(reset[:, None, None], 0.0)
        self._nhist.masked_fill_(reset, 0)
        st = torch.where(reset[:, None], self._init_st, self._st)
        sc = torch.where(reset[:, None], self._init_sc, self._sc)

        # feature ring: shift in the chunk, fbank over [N, BUF]
        shifted = torch.cat([self._buf, chunks], dim=1)[:, C:]
        self._buf = torch.where(active[:, None], shifted, self._buf)
        fr = self.computer(self._buf, self.feat_opts)            # [N, F, D]
        ar_f = torch.arange(F, device=dev)
        rolled = torch.gather(fr, 1, ((ar_f[None] + v0[:, None]) % F)
                              [:, :, None].expand(N, F, D))
        cat = torch.cat([self._fifo, rolled], dim=1)            # [N, M+F, D]
        # dynamic_slice_in_dim clamps its start to [0, F]
        start = torch.clamp(nf, 0, F)[:, None] + torch.arange(M, device=dev)
        self._fifo = torch.gather(cat, 1, start[:, :, None].expand(N, M, D))
        self._nhist = torch.clamp(self._nhist + nf, max=M)
        if n_frames == 0:             # no slot has a frame to decode yet
            self._st, self._sc = st, sc
            return
        gidx = d0[:, None] - self.lc + torch.arange(Mw, device=dev)[None]
        # jnp.clip(x, lo, hi) = min(max(x, lo), hi), also when lo > hi
        fidx = torch.maximum(gidx - total[:, None] + M,
                             (M - self._nhist)[:, None]).clamp(max=M - 1)
        window = torch.gather(self._fifo, 1,
                              fidx[:, :, None].expand(N, Mw, D))
        log_post = self.model(window, pad_context=False)     # [N, ndmax, P]
        ll_raw = log_post - self._log_prior
        ll = ll_raw * float(self.dec.opts.acoustic_scale)

        # lockstep token passing: stream n decodes its j-th new frame at
        # loop step j; the mask gates slots whose nd is smaller
        ll_t = ll[:, :n_frames].transpose(0, 1).contiguous()   # [nfr, N, P]
        mask = (torch.arange(n_frames, device=dev)[:, None]
                < nd[None, :])                                  # [nfr, N]
        emit_round, eps_round = self._rounds
        R, K = self.R, self.K
        recs = torch.empty((n_frames, R, N, K), dtype=torch.int32, device=dev)
        ils = torch.empty((n_frames, N, K), dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        for j in range(n_frames):
            m = mask[j][:, None]
            st2, sc2, rec, il, _ovf = emit_round(st, sc, ll_t[j])
            torch.where(m, rec, self._self_prev, out=recs[j, 0])
            for r in range(1, R):
                st2, sc2, rec, _il, _o = eps_round(st2, sc2)
                torch.where(m, rec, self._self_prev, out=recs[j, r])
            torch.where(m, il, zero, out=ils[j])
            st = torch.where(m, st2, st)
            sc = torch.where(m, sc2, sc)
        self._st, self._sc = st, sc
        # arena and il-array writes at each slot's d0, in place
        # (dynamic_update_slice clamps d0 to [0, t_max])
        rows = (torch.clamp(d0, 0, self.t_max)[:, None]
                + torch.arange(n_frames, device=dev)[None])     # [N, nfr]
        slot = torch.arange(N, device=dev)[:, None].expand(N, n_frames)
        self._arena.index_put_((slot, rows), recs.permute(2, 0, 1, 3))
        self._ilar.index_put_((slot, rows), ils.permute(1, 0, 2))
        if self._keep_ll:
            self._llar.index_put_((slot, rows), ll_raw[:, :n_frames])

    # ------------------------------------------------------------- slots

    def open(self) -> int | None:
        """Claim a stream slot (None if the batch is full)."""
        if not self._free:
            return None
        s = self._free.pop()
        self._in_use[s] = True
        self._pending_reset[s] = True
        self._stage[s] = np.zeros(0, np.float32)
        self._samples[s] = self._chunks[s] = 0
        self._frames[s] = self._decoded[s] = 0
        self._want_flush[s] = self._flushed[s] = False
        return s

    def feed(self, s: int, wave: np.ndarray):
        if not self._in_use[s] or self._want_flush[s]:
            raise ValueError(f"slot {s} is not open for input")
        self._stage[s] = np.concatenate(
            [self._stage[s], np.asarray(wave, np.float32)])
        self._samples[s] += len(wave)

    def input_finished(self, s: int):
        if not self._in_use[s]:
            raise ValueError(f"slot {s} is not open")
        self._want_flush[s] = True

    def finished(self, s: int) -> bool:
        return bool(self._flushed[s])

    def close(self, s: int):
        if not self._in_use[s]:
            raise ValueError(f"slot {s} is not open")
        self._in_use[s] = False
        self._free.append(s)

    def pending(self, s: int) -> int:
        """Staged samples not yet dispatched."""
        return len(self._stage[s])

    # -------------------------------------------------------------- step

    def step(self) -> list[int]:
        """Advance every slot that has a full chunk staged (or is flushing)
        by one chunk, in one batched device step. Returns the advanced
        slots; call repeatedly to drain multi-chunk stages."""
        N, C = self.N, self.C
        chunks = np.zeros((N, C), np.float32)
        # rows: active, reset, nf, v0, nd, d0, total
        ctrl = np.zeros((7, N), np.int64)
        active, nf, v0, nd, d0, total = (ctrl[0], ctrl[2], ctrl[3], ctrl[4],
                                         ctrl[5], ctrl[6])
        advanced = []
        fo = self.feat_opts.frame_opts
        for s in range(N):
            if not self._in_use[s]:
                continue
            flush = self._want_flush[s] and not self._flushed[s]
            if len(self._stage[s]) >= C:
                chunks[s] = self._stage[s][:C]
                self._stage[s] = self._stage[s][C:]
            elif flush and len(self._stage[s]) < C:
                chunks[s, :len(self._stage[s])] = self._stage[s]
                self._stage[s] = np.zeros(0, np.float32)
                self._flushed[s] = True
            else:
                total[s] = self._frames[s]
                d0[s] = self._decoded[s]
                continue
            active[s] = 1
            fed = (self._chunks[s] + 1) * C
            tot = num_frames(int(min(self._samples[s], fed)), fo)
            nf[s] = tot - self._frames[s]
            v0[s] = self._frames[s] - (fed - self.BUF) // self.shift
            if self._flushed[s]:
                nd_end = tot
            else:
                nd_end = max(self._decoded[s], tot - self.rc)
            nd[s] = nd_end - self._decoded[s]
            d0[s] = self._decoded[s]
            total[s] = tot
            if nd_end > self.t_max:
                raise RuntimeError(f"slot {s} exceeds t_max={self.t_max} "
                                   f"frames")
            self._chunks[s] += 1
            self._frames[s] = tot
            self._decoded[s] = nd_end
            advanced.append(s)
        if not advanced:
            return []
        ctrl[1] = self._pending_reset
        self._pending_reset[:] = False
        mine = slice(self._lo, self._lo + self._nl)
        self._dispatch(torch.as_tensor(chunks[mine], device=self.device),
                       torch.as_tensor(ctrl[:, mine], device=self.device),
                       int(nd[mine].max()))
        return advanced

    def drain(self, s: int):
        """Step until slot s has consumed its stage (incl. flush)."""
        while (len(self._stage[s]) >= self.C or
               (self._want_flush[s] and not self._flushed[s])):
            self.step()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ results

    def _on_owner(self, s: int, fn):
        """fn(local index of s) on the rank that holds slot s, its result
        broadcast over the mesh axis (just fn without a mesh)."""
        owner = s // self._nl
        res = fn(s - self._lo) if owner == self._coord else None
        if self._mesh is None:
            return res
        return broadcast_object(res, owner, self._mesh, self._axis)

    def best_path(self, s: int, use_final_probs: bool = True):
        """-> (words, tids, cost) of slot s, or None if no token is alive.
        The traceback walks the arena on the device; its result comes to
        the host in one copy, and the start state's closure records finish
        the walk there."""
        return self._on_owner(
            s, lambda i: self._best_path(i, int(self._decoded[s]),
                                         use_final_probs))

    @torch.no_grad()
    def _best_path(self, s: int, n: int, use_final_probs: bool):
        """best_path of this device's slot s, n frames decoded."""
        dev, R = self.device, self.R
        st0, sc0 = self._st[s], self._sc[s]
        costs = sc0 + self.dec.tabs.final[st0.long()]
        use_f = torch.min(costs) < _HALF_BIG
        if not use_final_probs:
            use_f = torch.zeros_like(use_f)
        slot = torch.where(use_f, torch.argmin(costs),
                           torch.argmin(sc0)).reshape(1)
        cost0 = torch.where(use_f, torch.min(costs), torch.min(sc0))
        alive = torch.min(sc0) < _HALF_BIG
        prs = torch.empty((n, R), dtype=torch.int32, device=dev)
        ils = torch.empty(n, dtype=torch.int32, device=dev)
        arena, ilar = self._arena[s], self._ilar[s]
        for tt in range(n - 1, -1, -1):
            for r in range(R - 1, 0, -1):
                torch.index_select(arena[tt, r], 0, slot,
                                   out=prs[tt, r:r + 1])
                slot = prs[tt, r:r + 1] & self._kmask
            torch.index_select(ilar[tt], 0, slot, out=ils[tt:tt + 1])
            torch.index_select(arena[tt, 0], 0, slot, out=prs[tt, 0:1])
            slot = prs[tt, 0:1] & self._kmask
        ols, ils, slot_end, cost, alive = fetch_host(
            [prs >> self._kbits, ils, slot, cost0, alive])
        if not bool(alive):
            return None
        words = [int(o) for o in ols.reshape(-1) if o != 0]
        tids = [int(i) for i in ils if i != 0]
        init_words = []
        slot = int(slot_end[0])
        for (pv, ol) in reversed(self._init_records):
            o = int(ol.reshape(-1)[slot])
            if o != 0:
                init_words.append(o)
            slot = int(pv.reshape(-1)[slot])
        return init_words[::-1] + words, tids, float(cost)

    def get_lattice(self, s: int, lattice_beam: float = 8.0):
        """Raw lattice of stream s: the offline latgen (decode_to_lattices)
        over its kept log-likelihoods, so it equals the offline lattice of
        the same audio. Needs keep_loglikes=True."""
        if not self._keep_ll:
            raise ValueError("get_lattice needs a server built with "
                             "keep_loglikes=True")
        n = int(self._decoded[s])
        if n == 0:
            return None

        def lattice(i):
            ll = self._llar[i, :n].cpu().numpy()
            return decode_to_lattices(self.dec, ll[None],
                                      np.array([n], np.int32),
                                      lattice_beam)[0]
        return self._on_owner(s, lattice)
