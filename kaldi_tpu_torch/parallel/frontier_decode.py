"""Frontier-sharded beam search over the ranks of a mesh axis.

Counterpart of kaldi_tpu/parallel/frontier_decode.py (SURVEY.md §2.11's
big-graph prescription): when one utterance's decode must scale past a
device (giant HCLG, low-latency single stream), the token frontier itself
shards over devices. Each rank expands its K/D slice of the frontier
through its (replicated) tier tables, the candidate sets are all-gathered
over the axis in rank order, and dedup and selection run replicated, so
every rank holds the identical next frontier. Utterance-level sharding
(parallel.mesh.decode_sharded) covers the reference's job arrays; this
module covers the scaling axis it does not have.

The JAX module is one `shard_map` program; here every rank runs the same
host loop (SPMD) and the exchange is one `all_gather` per round of one
packed [4, C] int32 tensor (state, score bits, back-pointer, ilabel), so
it is bit-exact and needs no zero padding (a sum-reduce of padded buffers
would turn -0.0 into +0.0, and the selection orders signed zeros). The
rounds reuse the port's `csr_beam` internals (`_segment_map`, the tier
tables, `_hub_state_arr`); the acoustic and frontier-score lookups of the
emitting round go through the table-gather kernel at B = 1, as the
CsrBeamDecoder's do. `_make_rounds` (decoder/csr_beam.py) is the unsharded
counterpart. Frames past an utterance's end are not run: JAX runs them
masked, as no-ops whose records are identities, so the traceback is the
same. The traceback runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kaldi_tpu_torch.decoder.csr_beam import (_HALF_BIG, BIG, CsrBeamDecoder,
                                              _bits_to_f32, _cumsum32,
                                              _f32_sort_key, _f32_total_key,
                                              _segment_map)
from kaldi_tpu_torch.decoder.hostpack import fetch_host
from kaldi_tpu_torch.ops.table_gather import batched_table_gather
from kaldi_tpu_torch.parallel.mesh import axis_index, axis_size, check_mesh


def _dedup_topk(cst, csc, crec, cil, K: int):
    """JAX's frontier `dedup_topk`: a stable sort by (state, score) (signed
    zeros equal, as lax.sort compares them), run heads win, then the K best
    heads by lax.top_k(-sel)'s order: ascending, -0.0 before +0.0, ties to
    the lowest index. All arrays [C]."""
    key = cst.to(torch.int64) * (1 << 32) + _f32_sort_key(csc)
    order = torch.sort(key, stable=True).indices
    ss, ssc = cst[order], csc[order]
    first = torch.ones_like(ss, dtype=torch.bool)
    first[1:] = ss[1:] != ss[:-1]
    sel = torch.where(first, ssc, float(BIG))
    kidx = torch.sort(_f32_total_key(sel), stable=True).indices[:K]
    idx = order[kidx]
    return (ss[kidx], torch.clamp(sel[kidx], max=float(BIG)), crec[idx],
            cil[idx])


class _Rounds:
    """The sharded emitting and eps rounds of one decoder on one mesh axis
    (JAX's `_make_fs_decode` closures)."""

    def __init__(self, dec: CsrBeamDecoder, mesh, axis: str):
        o, t = dec.opts, dec.tabs
        self.t = t
        self.K = K = int(o.max_active)
        self.D = D = axis_size(check_mesh(mesh), axis)
        if K % D:
            raise ValueError(f"max_active {K} does not split over {axis}={D}")
        self.Kl = Kl = K // D
        self.CB = max(int(o.expand_budget) // D, Kl)
        self.CZ = max(int(o.eps_budget) // D, Kl)
        self.beam = float(o.beam)
        self.kbits = max((K - 1).bit_length(), 1)
        self.H = len(t.hub_bounds) - 1
        self.group = mesh.get_group(axis) if D > 1 else None
        self.rounds = 0             # exchanges made
        self.gathered_bytes = 0     # bytes each rank received from them
        self.lo = lo = axis_index(mesh, axis) * Kl
        dev = dec.device
        self.dev = dev
        self.slots = torch.arange(lo, lo + Kl, dtype=torch.int32, device=dev)
        self.zeros = torch.zeros(Kl, dtype=torch.int32, device=dev)
        self.hub_state_arr = dec._hub_state_arr
        if self.H:
            AH = t.hub_rows.shape[0]
            if AH < K:
                raise ValueError(f"{AH} hub arcs < max_active {K}: the "
                                 f"frontier's hub top-K needs at least K")
            self.arc_hub = torch.as_tensor(
                np.repeat(np.arange(self.H), np.diff(np.asarray(t.hub_bounds))),
                device=dev)

    def exchange(self, cands):
        """Concatenate this rank's candidates, all-gather them over the
        axis in rank order (one packed int32 tensor), cut at the beam, and
        keep the best per state and the K best. -> (state, score, rec,
        ilabel), each [K], identical on every rank."""
        cst, csc, crec, cil = (torch.cat([c[i] for c in cands])
                               for i in range(4))
        packed = torch.stack([cst, csc.view(torch.int32), crec, cil])
        if self.group is not None:
            parts = [torch.empty_like(packed) for _ in range(self.D)]
            dist.all_gather(parts, packed, group=self.group)
            self.gathered_bytes += packed.numel() * 4 * self.D
            packed = torch.cat(parts, dim=1)
        self.rounds += 1
        cst, crec, cil = packed[0], packed[2], packed[3]
        csc = packed[1].view(torch.float32)
        best = torch.amin(csc)
        csc = torch.where(csc > best + self.beam, float(BIG), csc)
        return _dedup_topk(cst, csc, crec, cil, self.K)

    def emit(self, tok_state, tok_score, ll_t):
        """One emitting round over this rank's K/D slice; ll_t [1, P]
        contiguous. -> (state, score, rec, ilabel, dropped tier-B arcs)."""
        t, Kl, lo, kb = self.t, self.Kl, self.lo, self.kbits
        apr = t.b_apr
        ts, sc = tok_state[lo:lo + Kl], tok_score[lo:lo + Kl]
        row = t.srow.index_select(0, ts)                    # [Kl, 16]
        # tier B (row-budgeted packed arc rows, quad or triple layout)
        deg = torch.where(sc < _HALF_BIG, row[:, 11], 0)
        rows_n = (deg + (apr - 1)) // apr
        roff = _cumsum32(rows_n[None])[0] - rows_n
        CBR = -(-self.CB // apr)
        tj, rj, valid, _ovr = _segment_map(roff[None], rows_n[None], CBR, Kl,
                                           1, base=row[None, :, 10])
        tj, rj, valid = tj[0], rj[0], valid[0]
        rj = torch.where(valid, rj, 0)
        arcr = t.brow.index_select(0, rj)                   # [CBR, 16]
        base_b = batched_table_gather(sc[None].contiguous(), tj[None])[0]
        base_b = torch.where(valid, base_b, float(BIG))
        if apr == 4:
            b_pdf = [arcr[:, 4 * k + 2] & 0xFFFF for k in range(4)]
        else:
            b_pdf = [arcr[:, 5 * k + 2] for k in range(3)]
        # ONE acoustic lookup for every tier-A and tier-B candidate
        am_cat = -batched_table_gather(
            ll_t, torch.cat([row[:, 2], row[:, 7]] + b_pdf)[None])[0]
        cands = []
        for j in (0, 1):
            base = 5 * j
            cost = _bits_to_f32(row[:, base])
            am = am_cat[j * Kl:(j + 1) * Kl]
            csc = torch.where(cost < _HALF_BIG, sc + cost + am, float(BIG))
            cands.append((row[:, base + 1], csc,
                          self.slots | (row[:, base + 4] << kb),
                          row[:, base + 3]))
        off = 2 * Kl
        for k in range(apr):
            if apr == 4:
                base = 4 * k
                tid = (arcr[:, base + 2] >> 16) & 0xFFFF
                ol = arcr[:, base + 3]
            else:
                base = 5 * k
                tid, ol = arcr[:, base + 3], arcr[:, base + 4]
            cost = _bits_to_f32(arcr[:, base])
            am = am_cat[off:off + CBR]
            off += CBR
            csc = torch.where(cost < _HALF_BIG, base_b + cost + am, float(BIG))
            cands.append((arcr[:, base + 1], csc, (lo + tj) | (ol << kb), tid))
        kept_rows = torch.minimum(torch.clamp(CBR - roff, min=0), rows_n)
        ovf = torch.sum(deg - torch.minimum(deg, apr * kept_rows),
                        dtype=torch.int64)
        if self.H:
            cands.append(self._hubs(tok_state, tok_score, ll_t))
        return self.exchange(cands) + (ovf,)

    def _hubs(self, tok_state, tok_score, ll_t):
        """Hub scoring over the FULL frontier (replicated dense work); this
        rank emits its slice [lo, lo + K/D) of the global hub top-K, so the
        gathered union is the unsharded decoder's hub candidates."""
        t, Kl, lo = self.t, self.Kl, self.lo
        match = (tok_state[:, None] == self.hub_state_arr[None, :]) & \
            (tok_score[:, None] < _HALF_BIG)                # [K, H]
        msc = torch.where(match, tok_score[:, None], float(BIG))
        hub_slot = torch.argmin(msc, dim=0)                 # first minimum
        hub_sc = torch.gather(msc, 0, hub_slot[None])[0]
        base = hub_sc[self.arc_hub]
        slot_flat = hub_slot.to(torch.int32)[self.arc_hub]
        if t.hub_onehot is not None:
            am_g = -ll_t[:, t.hub_gpdf.long()]              # [1, Gpad]
            am_flat = torch.matmul(am_g, t.hub_onehot.T)[0]
        else:
            am_flat = -batched_table_gather(ll_t, t.hub_pdf[None])[0]
        sc_flat = base + t.hub_cost + am_flat
        idx = torch.sort(_f32_total_key(sc_flat),
                         stable=True).indices[lo:lo + Kl]
        rows = t.hub_rows.index_select(0, idx)
        return (rows[:, 1], torch.clamp(sc_flat[idx], max=float(BIG)),
                slot_flat[idx] | (rows[:, 4] << self.kbits), rows[:, 3])

    def eps(self, tok_state, tok_score):
        """One eps round over this rank's slice. -> (state, score, rec,
        ilabel, dropped tier-B eps arcs)."""
        t, Kl, lo, kb = self.t, self.Kl, self.lo, self.kbits
        ts, sc = tok_state[lo:lo + Kl], tok_score[lo:lo + Kl]
        row = t.zrow.index_select(0, ts)                    # [Kl, 8]
        cands = [(ts, sc, self.slots, self.zeros)]
        for j in (0, 1):
            base = 3 * j
            cost = _bits_to_f32(row[:, base])
            csc = torch.where(cost < _HALF_BIG, sc + cost, float(BIG))
            cands.append((row[:, base + 1], csc,
                          self.slots | (row[:, base + 2] << kb), self.zeros))
        ovf = torch.zeros((), dtype=torch.int64, device=self.dev)
        if t.zbrow.shape[0] > 1:     # tier-B eps (eps fan-out > 2)
            deg = torch.where(sc < _HALF_BIG, row[:, 7], 0)
            coff = _cumsum32(deg[None])[0] - deg
            tj, aj, valid, ovf_z = _segment_map(coff[None], deg[None],
                                                self.CZ, Kl, 1,
                                                base=row[None, :, 6])
            tj, aj, valid = tj[0], aj[0], valid[0]
            aj = torch.where(valid, aj, 0)
            arc = t.zbrow.index_select(0, aj)
            cost = _bits_to_f32(arc[:, 0])
            csc = torch.where(valid, sc[tj.long()] + cost, float(BIG))
            cands.append((arc[:, 1], csc, (lo + tj) | (arc[:, 2] << kb),
                          torch.zeros_like(tj)))
            ovf = ovf + ovf_z[0]
        return self.exchange(cands) + (ovf,)


def _decode_one(rd: _Rounds, dec: CsrBeamDecoder, ll, n_frames: int,
                n_eps: int):
    """One utterance, ll [T, P] scaled. -> (init_recs [R0, K], recs
    [n_frames, R, K], il_emit [n_frames, K], best slot, best cost,
    overflow), the overflow summed over the axis."""
    K, dev = rd.K, rd.dev
    st = torch.zeros(K, dtype=torch.int32, device=dev)
    st[0] = int(dec.csr.start)
    sc = torch.full((K,), float(BIG), dtype=torch.float32, device=dev)
    sc[0] = 0.0
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    init_recs = torch.empty((n_eps, K), dtype=torch.int32, device=dev)
    for r in range(n_eps):
        st, sc, init_recs[r], _il, o = rd.eps(st, sc)
        ovf = ovf + o
    recs = torch.empty((n_frames, 1 + n_eps, K), dtype=torch.int32,
                       device=dev)
    il_emit = torch.empty((n_frames, K), dtype=torch.int32, device=dev)
    for f in range(n_frames):
        st, sc, recs[f, 0], il_emit[f], o = rd.emit(st, sc, ll[f:f + 1])
        ovf = ovf + o
        for r in range(1, 1 + n_eps):
            st, sc, recs[f, r], _il, o = rd.eps(st, sc)
            ovf = ovf + o
    # each rank counted the arcs its own slice dropped: the global count
    # is their sum over the axis
    if rd.group is not None:
        dist.all_reduce(ovf, group=rd.group)
    total = sc + dec.tabs.final[st.long()]
    bslot = torch.argmin(total)
    aslot = torch.argmin(sc)
    ok = total[bslot] < _HALF_BIG
    bcost = torch.where(ok, total[bslot], sc[aslot])
    bslot = torch.where(ok, bslot, aslot)
    return init_recs, recs, il_emit, bslot, bcost, ovf


def decode_frontier_sharded(dec: CsrBeamDecoder, loglikes, num_frames,
                            mesh, axis: str = "model"):
    """Single-stream decode with the frontier sharded over `axis`; every
    rank of the axis makes the same call with the same inputs.

    -> list of per-utterance (words, tids, total_cost) or None, as
    CsrBeamDecoder.decode (utterances run one after another: this mode
    targets one giant-graph stream; batch throughput uses
    decode_sharded). Sets dec.last_overflow [B] (dropped arcs, summed
    over the axis), dec.last_exchange_rounds and
    dec.last_gathered_bytes (the bytes each rank received from the
    all-gathers, its own slice included)."""
    rd = _Rounds(dec, mesh, axis)
    n_eps = int(dec.opts.eps_expansions)
    kmask = (1 << rd.kbits) - 1
    ll_all = torch.as_tensor(loglikes)
    nf = np.asarray(num_frames)
    out = []
    overflow = np.zeros(len(nf), np.int64)
    for b in range(len(nf)):
        ll = ll_all[b].to(device=rd.dev, dtype=torch.float32) \
            * dec.opts.acoustic_scale
        init_recs, recs, il_emit, bslot, bcost, ovf = fetch_host(
            list(_decode_one(rd, dec, ll.contiguous(), int(nf[b]), n_eps)))
        overflow[b] = int(ovf)
        if bcost >= BIG * 0.5:
            out.append(None)
            continue
        # host traceback (JAX's, over the live frames)
        words_rev, tids_rev = [], []
        s = int(bslot)
        R = recs.shape[1]
        for ti in range(recs.shape[0] - 1, -1, -1):
            for r in range(R - 1, -1, -1):
                if r == 0:
                    il = int(il_emit[ti, s])
                    if il:
                        tids_rev.append(il)
                pr = int(recs[ti, r, s])
                if pr >> rd.kbits:
                    words_rev.append(pr >> rd.kbits)
                s = pr & kmask
        for r in range(init_recs.shape[0] - 1, -1, -1):
            pr = int(init_recs[r, s])
            if pr >> rd.kbits:
                words_rev.append(pr >> rd.kbits)
            s = pr & kmask
        out.append((words_rev[::-1], tids_rev[::-1], float(bcost)))
    dec.last_overflow = overflow
    dec.last_exchange_rounds = rd.rounds
    dec.last_gathered_bytes = rd.gathered_bytes
    return out
