"""Degree-tiered beam search for production-scale HCLG graphs, on tensors.

Counterpart of kaldi_tpu/decoder/csr_beam.py (ref:
decoder/lattice-faster-decoder.cc:660-750 ProcessEmitting /
ProcessNonemitting): the best-path program with its on-device traceback,
the record program for lattice generation (`decode_raw`), and the chunked
and adaptive decoders. Read the JAX module for the design; this port
keeps its semantics exactly:

  - the tier tables are the same numpy packing (`build_tier_tables`),
    returned as torch tensors on the decoder's device: tier A (deg <= 2)
    inline in one [S, 16] row, tier B in packed arc rows (quad or triple
    layout) reached through a budgeted segmented gather, hubs dense with a
    one-hot f32 product (G <= 128) or a pdf gather (G > 128);
  - per frame: expand tiers -> beam cutoff vs frame best -> stable-sort
    dedup by target state (candidate order breaks ties) -> the K best
    winners, score-sorted, then (best-path programs) re-sorted by state;
  - back-pointers pack `prev_slot | olabel << kbits` into int32;
  - the record program keeps the score-sorted frontier and ships each
    round's snapshot compacted on the device (`rec_beam`, `rec_cap`,
    float16 relative scores, flat packing); lattices are extracted from
    the snapshots on the host (kaldi_tpu_torch.lat.generate).

What changes with the framework: `lax.scan` is a Python loop over frames
that enqueues device work without synchronising; the two-key sort is one
stable sort of an int64 key (state, order-preserving score bits);
`lax.top_k` is a stable sort cut to HC (ties go to the lowest index);
`.at[].max/.add(mode="drop")` scatter into one spare slot that is cut off.
`dynamic_update_slice` of a flat record window is a `scatter_` of
[B, Kc] columns; the record tensors of a batch come to the host in one
copy (`hostpack.fetch_host`). The acoustic and frontier-score lookups go
through the table-gather kernel (kaldi_tpu_torch.ops.table_gather) in
every program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.decoder.graph_pack import (PackedGraph, SplitCsr,
                                                eps_depth, fold_epsilons,
                                                split_csr)
from kaldi_tpu_torch.decoder.hostpack import (device_mask, fetch_host,
                                              parse_label_seqs)
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops.table_gather import batched_table_gather

BIG = np.float32(1e10)
BIG_BITS = int(np.array(1e10, np.float32).view(np.int32))  # f32 bit pattern
INT_BIG = np.int32(2**30)
_HALF_BIG = float(BIG * 0.5)


@dataclasses.dataclass(frozen=True)
class CsrBeamOpts:
    """(ref: decoder/lattice-faster-decoder.h:40-90 LatticeFasterDecoderConfig)

    Same fields as kaldi_tpu's CsrBeamOpts. The lattice-record fields
    (rec_*) act on decode_raw only."""

    beam: float = 13.0
    max_active: int = 7000      # frontier capacity K (tokens kept per frame)
    acoustic_scale: float = 0.1
    eps_expansions: int | None = None   # None = infer exact eps depth
    expand_budget: int = 32768  # tier-B emitting candidate slots per frame
    eps_budget: int = 4096      # tier-B eps candidate slots per round
    hub_threshold: int = 1024   # out-degree above which a state is a hub
    hub_cap: int | None = None  # hub candidates entering the merge per
                                # frame (None = max_active = exact);
                                # within-beam candidates beyond the cap
                                # are counted into last_overflow
    exact_dedup: bool = False   # retained for API compat: dedup is always
                                # bit-exact
    force_b_triple: bool = False  # pin the tier-B triple row layout
    fold_eps: bool = True       # eps-remove the graph at pack time when
                                # exactly representable (fold_epsilons)
    # record compaction (decode_raw): each snapshot keeps the slots within
    # rec_beam of the frame best and ships its first rec_cap slots; alive
    # slots past the cap are counted in last_rec_trunc
    rec_cap: int | None = None   # None = max_active: no truncation
    rec_beam: float | None = None  # None = beam: no extra pruning
    rec_f16: bool = False        # ship scores as float16 relative to the
                                 # frame best (f32 rebuilt on the host)
    rec_flat: bool = False       # pack the alive prefixes into one buffer
                                 # per utterance
    rec_flat_cap: int = 512      # flat slots per (frame, round); overflow
                                 # redoes the batch with dense records and
                                 # counts it in last_flat_fallbacks


@dataclasses.dataclass
class TierTables:
    """Device-resident tier tables built once per graph (layouts as in
    kaldi_tpu.decoder.csr_beam.TierTables)."""

    srow: torch.Tensor      # [S, 16] int32 packed per-state emitting row
    zrow: torch.Tensor      # [S, 8] int32 packed per-state eps row
    brow: torch.Tensor      # [ABR, 16] int32 tier-B arc rows (quad/triple)
    zbrow: torch.Tensor     # [AZB, 8] int32 tier-B eps arc rows
    final: torch.Tensor     # [S] f32
    hub_states: np.ndarray      # [H] int64 host-side
    hub_bounds: tuple           # H+1 python ints: flat arc ranges per hub
    hub_rows: torch.Tensor      # [AH, 8] int32 (cost bits, nxt, pdf, tid, ol)
    hub_cost: torch.Tensor      # [AH] f32
    hub_onehot: torch.Tensor | None  # [AH, Gpad] f32 pdf-group one-hot
    hub_gpdf: torch.Tensor | None    # [Gpad] int32 distinct pdfs per group
    hub_pdf: torch.Tensor | None     # [AH] int32 (when G > 128)
    b_apr: int = 3                   # tier-B arcs per packed row (4 = quad)


def _pack_rows(cols: list[np.ndarray], width: int) -> np.ndarray:
    n = len(cols[0]) if cols else 0
    out = np.zeros((n, width), np.int32)
    for i, c in enumerate(cols):
        out[:, i] = c
    return out


def build_tier_tables(csr: SplitCsr, hub_threshold: int,
                      force_triple: bool = False,
                      device="cuda") -> TierTables:
    """Vectorized tier partition + row packing (numpy, runs once), copied
    from kaldi_tpu; the tables land on `device` (the card by default).

    force_triple pins the tier-B fallback layout (3 arcs x 5 lanes) even
    when the quad layout applies."""
    dev = resolve_device(device)
    S = csr.num_states
    e_deg = np.diff(csr.estart).astype(np.int64)
    z_deg = np.diff(csr.zstart).astype(np.int64)
    cost_bits = csr.e_cost.view(np.int32)
    z_cost_bits = csr.z_cost.view(np.int32)

    is_hub = e_deg > hub_threshold
    tier_a = (~is_hub) & (e_deg <= 2)
    tier_b = (~is_hub) & (e_deg > 2)

    # --- srow: tier A arcs inline + tier B CSR offsets
    srow = np.zeros((S, 16), np.int32)
    srow[:, 0] = BIG_BITS
    srow[:, 5] = BIG_BITS
    for j in (0, 1):
        has = tier_a & (e_deg > j)
        a = csr.estart[:-1][has] + j
        base = 5 * j
        srow[has, base + 0] = cost_bits[a]
        srow[has, base + 1] = csr.e_nxt[a]
        srow[has, base + 2] = csr.e_pdf[a]
        srow[has, base + 3] = csr.e_tid[a]
        srow[has, base + 4] = csr.e_ol[a]
    # tier B packed arc rows. QUAD when every tier-B pdf/tid/olabel fits
    # 16 bits: 4 arcs x (cost bits, nxt, pdf | tid << 16, olabel);
    # TRIPLE otherwise: 3 arcs x 5 lanes. Padding arcs are dead (cost = BIG).
    b_deg = np.where(tier_b, e_deg, 0)
    b_start = np.zeros(S + 1, np.int64)
    np.cumsum(b_deg, out=b_start[1:])
    AB = int(b_start[-1])
    if AB:
        bs = np.flatnonzero(tier_b)
        reps = e_deg[bs]
        offs = np.repeat(csr.estart[:-1][bs].astype(np.int64), reps)
        within = np.arange(AB) - np.repeat(b_start[bs], reps)
        src_idx = offs + within
        fits16 = (int(csr.e_pdf[src_idx].max(initial=0)) < (1 << 16)
                  and int(csr.e_tid[src_idx].max(initial=0)) < (1 << 16)
                  and int(csr.e_ol[src_idx].max(initial=0)) < (1 << 16))
        apr = 4 if (fits16 and not force_triple) else 3
    else:
        apr = 3
    b_rows = -(-b_deg // apr)
    r_start = np.zeros(S + 1, np.int64)
    np.cumsum(b_rows, out=r_start[1:])
    ABR = int(r_start[-1])
    if ABR:
        # at least 2 rows: a [1, 16] table is the EMPTY-tier dummy
        # sentinel (have_b = shape[0] > 1), and a real tier-B fitting
        # exactly one packed row must not be mistaken for it — the
        # padding row is dead (cost = BIG)
        brow = np.zeros((max(ABR, 2), 16), np.int32)
        for k in range(apr):
            brow[:, (4 if apr == 4 else 5) * k] = BIG_BITS
        rowi = np.repeat(r_start[bs], reps) + within // apr
        if apr == 4:
            colb = 4 * (within % 4)
            pt = (csr.e_pdf[src_idx].astype(np.uint32)
                  | (csr.e_tid[src_idx].astype(np.uint32) << np.uint32(16)))
            for c, vals in enumerate((cost_bits[src_idx],
                                      csr.e_nxt[src_idx],
                                      pt.view(np.int32),
                                      csr.e_ol[src_idx])):
                brow[rowi, colb + c] = vals
        else:
            colb = 5 * (within % 3)
            for c, vals in enumerate((cost_bits[src_idx],
                                      csr.e_nxt[src_idx],
                                      csr.e_pdf[src_idx],
                                      csr.e_tid[src_idx],
                                      csr.e_ol[src_idx])):
                brow[rowi, colb + c] = vals
    else:
        brow = np.zeros((1, 16), np.int32)
        for k in range(apr):
            brow[0, (4 if apr == 4 else 5) * k] = BIG_BITS
    srow[:, 10] = r_start[:-1]
    srow[:, 11] = b_deg

    # --- zrow: eps arcs (tier A inline; tier B CSR for deg > 2)
    zrow = np.zeros((S, 8), np.int32)
    zrow[:, 0] = BIG_BITS
    zrow[:, 3] = BIG_BITS
    z_a = z_deg <= 2
    for j in (0, 1):
        has = z_a & (z_deg > j)
        a = csr.zstart[:-1][has] + j
        base = 3 * j
        zrow[has, base + 0] = z_cost_bits[a]
        zrow[has, base + 1] = csr.z_nxt[a]
        zrow[has, base + 2] = csr.z_ol[a]
    zb_deg = np.where(z_a, 0, z_deg)
    zb_start = np.zeros(S + 1, np.int64)
    np.cumsum(zb_deg, out=zb_start[1:])
    AZB = int(zb_start[-1])
    if AZB:
        zs = np.flatnonzero(~z_a)
        reps = z_deg[zs]
        offs = np.repeat(csr.zstart[:-1][zs].astype(np.int64), reps)
        within = np.arange(AZB) - np.repeat(zb_start[zs], reps)
        zi = offs + within
        zbrow = _pack_rows([z_cost_bits[zi], csr.z_nxt[zi],
                            csr.z_ol[zi]], 8)
    else:
        zbrow = np.zeros((1, 8), np.int32)
        zbrow[0, 0] = BIG_BITS
    zrow[:, 6] = zb_start[:-1]
    zrow[:, 7] = zb_deg

    def t(a):
        return torch.as_tensor(a, device=dev)

    # --- hub tier: dense pdf-grouped arcs
    hubs = np.flatnonzero(is_hub)
    hub_bounds = [0]
    rows_parts = []
    cost_parts = []
    pdf_parts = []
    for h in hubs:
        a0, a1 = int(csr.estart[h]), int(csr.estart[h + 1])
        order = np.argsort(csr.e_pdf[a0:a1], kind="stable") + a0
        rows_parts.append(_pack_rows(
            [cost_bits[order], csr.e_nxt[order], csr.e_pdf[order],
             csr.e_tid[order], csr.e_ol[order]], 8))
        cost_parts.append(csr.e_cost[order])
        pdf_parts.append(csr.e_pdf[order])
        hub_bounds.append(hub_bounds[-1] + (a1 - a0))
    if hubs.size:
        hub_rows = np.concatenate(rows_parts)
        hub_cost = np.concatenate(cost_parts)
        hub_pdf = np.concatenate(pdf_parts)
        gpdf, ginv = np.unique(hub_pdf, return_inverse=True)
        G = len(gpdf)
        if G <= 128:
            Gpad = 128
            onehot = np.zeros((len(hub_pdf), Gpad), np.float32)
            onehot[np.arange(len(hub_pdf)), ginv] = 1.0
            gp = np.zeros(Gpad, np.int32)
            gp[:G] = gpdf
            hub_onehot = t(onehot)
            hub_gpdf = t(gp)
            hub_pdf_dev = None
        else:
            hub_onehot = None
            hub_gpdf = None
            hub_pdf_dev = t(hub_pdf.astype(np.int32))
        tables_hub = (hubs, tuple(hub_bounds), t(hub_rows), t(hub_cost),
                      hub_onehot, hub_gpdf, hub_pdf_dev)
    else:
        tables_hub = (hubs, (0,), torch.zeros((1, 8), dtype=torch.int32,
                                              device=dev),
                      torch.full((1,), float(BIG), dtype=torch.float32,
                                 device=dev), None, None, None)

    return TierTables(
        srow=t(srow), zrow=t(zrow), brow=t(brow), zbrow=t(zbrow),
        final=t(csr.final),
        hub_states=tables_hub[0], hub_bounds=tables_hub[1],
        hub_rows=tables_hub[2], hub_cost=tables_hub[3],
        hub_onehot=tables_hub[4], hub_gpdf=tables_hub[5],
        hub_pdf=tables_hub[6], b_apr=apr)


def _bits_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float32)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=torch.int32)


def _sort_order(key: torch.Tensor) -> torch.Tensor:
    """Indices of a stable ascending sort along dim 1."""
    return torch.sort(key, dim=1, stable=True).indices


def _f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 key in [0, 2^32) that orders like the f32 values, with
    -0.0 == +0.0 (JAX's sort canonicalises signed zeros; `+ 0.0` does it
    here)."""
    u = (x + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u + 0x80000000)


def _f32_total_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 key in [0, 2^32) that orders f32 values with -0.0 below
    +0.0, as XLA's TopK compares them."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u + 0x80000000)


def _segment_map(off, deg, C: int, K: int, B: int, base=None):
    """Load-balanced slot->token mapping for the budgeted tier: slot j of
    utterance b belongs to the token whose [off, off+deg) range contains j.

    Returns (tj, pos, valid, overflow) where pos[b, j] is the flat arc
    index `base[b, tj] + (j - off[b, tj])` (or just the within-segment
    offset when base is None), rebuilt from per-token deltas scattered at
    each run start and prefix-summed (as in kaldi_tpu). The flat index
    B*C is the "drop" slot of the JAX scatters: it gets a slot of its own
    here, which is cut off."""
    dev = off.device
    total = off[:, -1] + deg[:, -1]                       # [B]
    boff = (torch.arange(B, dtype=torch.int64, device=dev) * C)[:, None]
    flat_idx = torch.where(off < C, off.long() + boff, B * C).reshape(-1)
    vals = torch.where(deg > 0,
                       torch.arange(K, dtype=torch.int32, device=dev)[None, :],
                       0).reshape(-1)
    ids = torch.zeros(B * C + 1, dtype=torch.int32, device=dev)
    ids.scatter_reduce_(0, flat_idx, vals, reduce="amax", include_self=True)
    tj = torch.cummax(ids[:B * C].view(B, C), dim=1).values   # [B, C]
    j = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    val = (base - off) if base is not None else (-off)    # [B, K] per token
    delta = torch.cat([val[:, :1], val[:, 1:] - val[:, :-1]], dim=1)
    dsum = torch.zeros(B * C + 1, dtype=torch.int32, device=dev)
    dsum.index_add_(0, flat_idx, delta.reshape(-1))
    pos = j + _cumsum32(dsum[:B * C].view(B, C))          # [B, C]
    valid = j < total[:, None]
    overflow = torch.clamp(total - C, min=0)
    return tj, pos, valid, overflow


def _dedup_topk(c_state, c_score, c_rec, c_il, K: int,
                state_sort: bool = False):
    """Best token per state, then best K overall, score-sorted (then
    state-sorted when state_sort).

    The hash-free FindOrAddToken (ref: lattice-faster-decoder.cc:232): a
    stable sort by (state, score) groups each target state's candidates
    with its best first (candidate order breaks ties), a neighbour compare
    marks the run heads, and a second stable sort on the masked score keeps
    the K best winners. All arrays are [B, C]."""
    B, C = c_state.shape
    key = c_state.to(torch.int64) * (1 << 32) + _f32_sort_key(c_score)
    order = _sort_order(key)
    ss = torch.gather(c_state, 1, order)
    ssc = torch.gather(c_score, 1, order)
    first = torch.ones((B, C), dtype=torch.bool, device=c_state.device)
    first[:, 1:] = ss[:, 1:] != ss[:, :-1]
    sel = torch.where(first, ssc, float(BIG))             # dead sort last
    order2 = _sort_order(sel + 0.0)[:, :K]
    idx2 = torch.gather(order, 1, order2)                 # into candidates
    st2 = torch.gather(ss, 1, order2)
    sc2 = torch.clamp(torch.gather(sel, 1, order2), max=float(BIG))
    rec2 = torch.gather(c_rec, 1, idx2)
    il2 = torch.gather(c_il, 1, idx2)
    if state_sort:
        # best-path locality pass: order the kept tokens by STATE (dead
        # slots last via the 2^30 key)
        keyb = torch.where(sc2 < _HALF_BIG, st2, int(INT_BIG))
        o3 = _sort_order(keyb)
        st2, sc2, rec2, il2 = (torch.gather(a, 1, o3)
                               for a in (st2, sc2, rec2, il2))
    return st2, sc2, rec2, il2


def _make_rounds(srow, zrow, brow, zbrow,
                 hub_state_arr, hub_rows, hub_cost, hub_onehot, hub_gpdf,
                 hub_pdf, hub_bounds: tuple,
                 B: int, K: int, CB: int, CZ: int, beam: float,
                 HC: int | None = None, b_apr: int = 3,
                 state_sort: bool = True):
    """Build the per-frame (emit_round, eps_round) expansion steps over the
    tier tables for a [B, K] frontier (kaldi_tpu's `_make_rounds`).

    HC (hub_cap): at most HC hub candidates enter the merge per frame;
    within-beam candidates beyond rank HC are counted in the overflow."""
    dev = srow.device
    kbits = max((K - 1).bit_length(), 1)
    HC = K if HC is None else min(HC, K)
    H = len(hub_bounds) - 1
    have_b = brow.shape[0] > 1
    have_zb = zbrow.shape[0] > 1
    CBR = -(-CB // b_apr)   # tier-B budget in packed arc ROWS
    self_prev = torch.arange(K, dtype=torch.int32,
                             device=dev)[None, :].expand(B, K).contiguous()
    zeros_bk = torch.zeros((B, K), dtype=torch.int32, device=dev)
    if H:
        # hub index of each flat hub arc (the JAX code fills per-hub
        # column ranges; one gather through this map does the same)
        arc_hub = torch.as_tensor(
            np.repeat(np.arange(H), np.diff(np.asarray(hub_bounds))),
            device=dev)

    def rows_of(table, idx):
        return table.index_select(0, idx.reshape(-1)).view(
            *idx.shape, table.shape[1])

    def unpack_arc(row, base, with_pdf=True):
        cost = _bits_to_f32(row[..., base + 0])
        nxt = row[..., base + 1]
        if with_pdf:
            return cost, nxt, row[..., base + 2], row[..., base + 3], \
                row[..., base + 4]
        return cost, nxt, row[..., base + 2]

    def b_pdf(arcr, k):
        """pdf of packed tier-B sub-arc k (layout per b_apr)."""
        if b_apr == 4:
            return arcr[..., 4 * k + 2] & 0xFFFF
        return arcr[..., 5 * k + 2]

    def unpack_b_arc(arcr, k):
        """(cost, nxt, tid, ol) of packed tier-B sub-arc k."""
        if b_apr == 4:
            base = 4 * k
            tid = (arcr[..., base + 2] >> 16) & 0xFFFF
            return (_bits_to_f32(arcr[..., base]), arcr[..., base + 1],
                    tid, arcr[..., base + 3])
        base = 5 * k
        return (_bits_to_f32(arcr[..., base]), arcr[..., base + 1],
                arcr[..., base + 3], arcr[..., base + 4])

    def take_ll(ll_t, pdf):
        """Batched lookup: ll_t [B, P] (contiguous), pdf [B, N] -> [B, N],
        through the table-gather kernel on CUDA."""
        return batched_table_gather(ll_t, pdf.reshape(B, -1)) \
            .reshape(pdf.shape)

    def tier_b_emit(tok_score, row):
        """Row-budgeted expansion over the packed arc table: CBR row
        slots, each yielding b_apr candidates from one row fetch. Returns
        the gathered rows + per-slot base scores/token slots. Overflow is
        counted exactly in ARCS."""
        off_all = row[..., 10]                    # brow ROW offsets
        deg = torch.where(tok_score < _HALF_BIG, row[..., 11], 0)
        rows_n = (deg + (b_apr - 1)) // b_apr
        roff = _cumsum32(rows_n) - rows_n
        tj, rj, valid, _ovr = _segment_map(roff, rows_n, CBR, K, B,
                                           base=off_all)
        base_sc = take_ll(tok_score, tj)
        base_sc = torch.where(valid, base_sc, float(BIG))
        rj = torch.where(valid, rj, 0)
        arcr = rows_of(brow, rj)                  # [B, CBR, 16]
        # exact dropped-arc count (rows tile token-contiguously)
        kept_rows = torch.minimum(torch.clamp(CBR - roff, min=0), rows_n)
        ovf = torch.sum(deg - torch.minimum(deg, b_apr * kept_rows), dim=1,
                        dtype=torch.int32)
        return (arcr, base_sc, tj), ovf

    def hub_emit(tok_state, tok_score, ll_t):
        """Dense per-hub expansion; returns the HC best hub candidates."""
        match = (tok_state[:, :, None] == hub_state_arr[None, None, :]) & \
            (tok_score[:, :, None] < _HALF_BIG)           # [B, K, H]
        msc = torch.where(match, tok_score[:, :, None], float(BIG))
        hub_slot = torch.argmin(msc, dim=1)               # first minimum
        hub_sc = torch.gather(msc, 1, hub_slot[:, None, :])[:, 0, :]
        base = hub_sc[:, arc_hub]                         # [B, AH]
        slot_flat = hub_slot.to(torch.int32)[:, arc_hub]
        if hub_onehot is not None:
            am_g = -ll_t[:, hub_gpdf.long()]              # [B, Gpad]
            # true f32 (TF32 off): each output is one exact product
            am_flat = torch.matmul(am_g, hub_onehot.T)
        else:
            am_flat = -take_ll(ll_t, hub_pdf[None, :].expand(
                B, hub_pdf.shape[0]).contiguous())
        sc_flat = base + hub_cost[None, :] + am_flat
        # exact HC-best hub candidates, ties to the lowest arc index and
        # -0.0 before +0.0 (lax.top_k's rule): a stable ascending sort of
        # the uncanonicalised key, cut to HC
        idx = _sort_order(_f32_total_key(sc_flat))[:, :HC]  # [B, HC]
        sc = torch.clamp(torch.gather(sc_flat, 1, idx), max=float(BIG))
        if HC >= K:
            hov = torch.zeros(B, dtype=torch.int32, device=dev)
        else:
            hub_best = torch.amin(sc_flat, dim=1, keepdim=True)
            n_in_beam = torch.sum(sc_flat <= hub_best + beam, dim=1,
                                  dtype=torch.int32)
            # no live token on any hub this frame -> nothing can bind
            hov = torch.where(hub_best[:, 0] < _HALF_BIG,
                              torch.clamp(n_in_beam - HC, min=0), 0)
        rows = rows_of(hub_rows, idx)                     # [B, HC, 8]
        prev = torch.gather(slot_flat, 1, idx)
        return (rows[..., 1], sc, prev | (rows[..., 4] << kbits),
                rows[..., 3]), hov

    def merge(cands):
        cst = torch.cat([c[0] for c in cands], dim=1)
        csc = torch.cat([c[1] for c in cands], dim=1)
        crec = torch.cat([c[2] for c in cands], dim=1)
        cil = torch.cat([c[3] for c in cands], dim=1)
        best = torch.amin(csc, dim=1, keepdim=True)
        csc = torch.where(csc > best + beam, float(BIG), csc)
        return cst, csc, crec, cil

    def emit_round(tok_state, tok_score, ll_t):
        row = rows_of(srow, tok_state)                    # [B, K, 16]
        pdfs = [row[..., 2], row[..., 7]]                 # tier-A arc pdfs
        if have_b:
            (arcr, base_b, tj_b), ovf = tier_b_emit(tok_score, row)
            pdfs.extend(b_pdf(arcr, k) for k in range(b_apr))
        else:
            ovf = torch.zeros(B, dtype=torch.int32, device=dev)
        # ONE fused acoustic lookup for every tier-A/B candidate
        am_cat = -take_ll(ll_t, torch.cat(pdfs, dim=1))
        cands = []
        off = 0
        for j in (0, 1):
            cost, nxt, pdf, tid, ol = unpack_arc(row, 5 * j)
            am = am_cat[:, off:off + K]
            off += K
            sc = torch.where(cost < _HALF_BIG, tok_score + cost + am,
                             float(BIG))
            cands.append((nxt, sc, self_prev | (ol << kbits), tid))
        if have_b:
            for k in range(b_apr):
                cost, nxt, tid, ol = unpack_b_arc(arcr, k)
                am_b = am_cat[:, off:off + CBR]
                off += CBR
                sc_b = torch.where(cost < _HALF_BIG, base_b + cost + am_b,
                                   float(BIG))
                cands.append((nxt, sc_b, tj_b | (ol << kbits), tid))
        if H:
            hub_cand, hov = hub_emit(tok_state, tok_score, ll_t)
            cands.append(hub_cand)
            ovf = ovf + hov
        cst, csc, crec, cil = merge(cands)
        st, sc, rec, il = _dedup_topk(cst, csc, crec, cil, K,
                                      state_sort=state_sort)
        return st, sc, rec, il, ovf

    def eps_round(tok_state, tok_score):
        row = rows_of(zrow, tok_state)                    # [B, K, 8]
        cands = [(tok_state, tok_score, self_prev, zeros_bk)]
        for j in (0, 1):
            cost, nxt, ol = unpack_arc(row, 3 * j, with_pdf=False)
            sc = torch.where(cost < _HALF_BIG, tok_score + cost, float(BIG))
            cands.append((nxt, sc, self_prev | (ol << kbits), zeros_bk))
        if have_zb:   # tier-B eps (rare: eps fan-out > 2)
            off_all = row[..., 6]
            deg = torch.where(tok_score < _HALF_BIG, row[..., 7], 0)
            coff = _cumsum32(deg) - deg
            tj, aj, valid, ovf = _segment_map(coff, deg, CZ, K, B,
                                              base=off_all)
            base_sc = torch.gather(tok_score, 1, tj.long())
            aj = torch.where(valid, aj, 0)
            arc = rows_of(zbrow, aj)
            cost = _bits_to_f32(arc[..., 0])
            sc = torch.where(valid, base_sc + cost, float(BIG))
            cands.append((arc[..., 1], sc,
                          tj | (arc[..., 2] << kbits), torch.zeros_like(tj)))
        else:
            ovf = torch.zeros(B, dtype=torch.int32, device=dev)
        cst, csc, crec, cil = merge(cands)
        st, sc, rec, il = _dedup_topk(cst, csc, crec, cil, K,
                                      state_sort=state_sort)
        return st, sc, rec, il, ovf

    return emit_round, eps_round


def _rounds_for(tabs: TierTables, hub_state_arr, B: int, K: int, CB: int,
                CZ: int, beam: float, HC: int | None, state_sort: bool):
    t = tabs
    return _make_rounds(
        t.srow, t.zrow, t.brow, t.zbrow, hub_state_arr, t.hub_rows,
        t.hub_cost, t.hub_onehot, t.hub_gpdf, t.hub_pdf, t.hub_bounds,
        B, K, CB, CZ, beam, HC, t.b_apr, state_sort=state_sort)


def _start_frontier(B: int, K: int, start: int, dev):
    """The [B, K] frontier before the first round: the start state alive
    at score 0 in slot 0, every other slot dead."""
    tok_state = torch.zeros((B, K), dtype=torch.int32, device=dev)
    tok_state[:, 0] = start
    tok_score = torch.full((B, K), float(BIG), dtype=torch.float32,
                           device=dev)
    tok_score[:, 0] = 0.0
    return tok_state, tok_score


def _frame_stats(sc, mask_f, ovf, zero, ovf_t, sat_t, nact_t):
    """Write one frame's counters in place: the dropped-arc count; the
    frontier's saturation (its worst slot alive means max_active bound
    the search this frame); its occupancy (alive tokens after the
    rounds). All 0 / False on frames past the utterance's end."""
    torch.where(mask_f, ovf, zero, out=ovf_t)
    alive = sc < _HALF_BIG
    torch.logical_and(mask_f, alive[:, -1], out=sat_t)
    torch.where(mask_f, torch.sum(alive, dim=1, dtype=torch.int32), zero,
                out=nact_t)


def _best_final(fs, fsc, final):
    """-> (best_slot [B] int64, best_cost [B]): the best token with its
    final cost added, or the best token at all when none is final."""
    total = fsc + final[fs.long()]
    best_final_slot = torch.argmin(total, dim=1)
    best_final_cost = torch.gather(total, 1, best_final_slot[:, None])[:, 0]
    best_any_slot = torch.argmin(fsc, dim=1)
    best_any_cost = torch.gather(fsc, 1, best_any_slot[:, None])[:, 0]
    reached_final = best_final_cost < _HALF_BIG
    return (torch.where(reached_final, best_final_slot, best_any_slot),
            torch.where(reached_final, best_final_cost, best_any_cost))


def _start_rounds(eps_round, B: int, K: int, start: int, n_eps: int, dev):
    """The start frontier through the init eps rounds -> (tok_state,
    tok_score, init_recs [B, R0, K])."""
    tok_state, tok_score = _start_frontier(B, K, start, dev)
    init_recs = []
    for _ in range(n_eps):
        tok_state, tok_score, rec, _il, _ovf = eps_round(tok_state, tok_score)
        init_recs.append(rec)
    init_recs = (torch.stack(init_recs, dim=1) if init_recs
                 else torch.zeros((B, 0, K), dtype=torch.int32, device=dev))
    return tok_state, tok_score, init_recs


def _frame_loop(rounds, tok_state, tok_score, ll_tb, mask_tb, recs, il_emit,
                t0: int, self_prev):
    """Advance the frontier over the frames of ll_tb [Tf, B, P] (each
    frame's [B, P] kernel table contiguous), writing frame j's
    back-pointer records into recs[t0 + j] ([R, B, K]) and its emitting
    ilabels into il_emit[t0 + j]; masked frames write identity records.
    -> (tok_state, tok_score, dropped arcs [Tf, B], saturated [Tf, B],
    alive tokens [Tf, B])."""
    emit_round, eps_round = rounds
    Tf, B, _P = ll_tb.shape
    R = recs.shape[1]
    dev = ll_tb.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ovf_t = torch.empty((Tf, B), dtype=torch.int32, device=dev)
    sat_t = torch.empty((Tf, B), dtype=torch.bool, device=dev)
    nact_t = torch.empty((Tf, B), dtype=torch.int32, device=dev)
    for j in range(Tf):
        mask_f = mask_tb[j]
        m = mask_f[:, None]
        st, sc, rec, il, ovf = emit_round(tok_state, tok_score, ll_tb[j])
        torch.where(m, rec, self_prev, out=recs[t0 + j, 0])
        torch.where(m, il, zero, out=il_emit[t0 + j])
        for r in range(1, R):
            st, sc, rec, _il, ovf_z = eps_round(st, sc)
            torch.where(m, rec, self_prev, out=recs[t0 + j, r])
            ovf = ovf + ovf_z
        _frame_stats(sc, mask_f, ovf, zero, ovf_t[j], sat_t[j], nact_t[j])
        tok_state = torch.where(m, st, tok_state)
        tok_score = torch.where(m, sc, tok_score)
    return tok_state, tok_score, ovf_t, sat_t, nact_t


def _csr_decode(ll, frame_mask, tabs: TierTables, hub_state_arr,
                start: int, K: int, CB: int, CZ: int, n_eps: int,
                beam: float, HC: int | None = None):
    """Best-path frame loop (kaldi_tpu `_csr_decode`, record_full=False).

    ll [B, T, P] scaled loglikes, frame_mask [B, T] bool, both on the
    tables' device. -> (init_recs [B, R0, K], recs [T, R, B, K],
    il_emit [T, B, K], best_slot [B], best_cost [B], overflow [B],
    saturated [B], active_sum [B], active_max [B])."""
    B, T, P = ll.shape
    dev = ll.device
    rounds = _rounds_for(tabs, hub_state_arr, B, K, CB, CZ, beam, HC,
                         state_sort=True)
    self_prev = torch.arange(K, dtype=torch.int32,
                             device=dev)[None, :].expand(B, K)
    tok_state, tok_score, init_recs = _start_rounds(rounds[1], B, K, start,
                                                    n_eps, dev)
    ll_tb = ll.transpose(0, 1).contiguous()
    mask_tb = frame_mask.transpose(0, 1).contiguous()
    recs = torch.empty((T, 1 + n_eps, B, K), dtype=torch.int32, device=dev)
    il_emit = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    tok_state, tok_score, ovf_t, sat_t, nact_t = _frame_loop(
        rounds, tok_state, tok_score, ll_tb, mask_tb, recs, il_emit, 0,
        self_prev)
    best_slot, best_cost = _best_final(tok_state, tok_score, tabs.final)
    return (init_recs, recs, il_emit, best_slot, best_cost,
            torch.sum(ovf_t, dim=0, dtype=torch.int32),
            torch.any(sat_t, dim=0),
            torch.sum(nact_t, dim=0, dtype=torch.int32),
            torch.amax(nact_t, dim=0))


def _traceback(recs, il_emit, init_recs, best_slot, K: int):
    """Walk the back-pointers from best_slot on the device: a reverse loop
    of [B]-sized gathers, so the [T, R, B, K] arena never leaves it.
    -> ([B, T, R] olabels, [B, T] tids, [B, R0] init olabels)."""
    kbits = max((K - 1).bit_length(), 1)
    kmask = (1 << kbits) - 1
    T, R, B, _K = recs.shape
    R0 = init_recs.shape[1]
    dev = recs.device
    ols = torch.empty((T, R, B), dtype=torch.int32, device=dev)
    ils = torch.empty((T, B), dtype=torch.int32, device=dev)
    s = best_slot[:, None].long()                           # [B, 1]
    for f in range(T - 1, -1, -1):
        for r in range(R - 1, -1, -1):
            if r == 0:
                ils[f] = torch.gather(il_emit[f], 1, s)[:, 0]
            pr = torch.gather(recs[f, r], 1, s)
            ols[f, r] = pr[:, 0] >> kbits
            s = (pr & kmask).long()
    init_ols = torch.empty((B, R0), dtype=torch.int32, device=dev)
    for r in range(R0 - 1, -1, -1):
        pr = torch.gather(init_recs[:, r], 1, s)
        init_ols[:, r] = pr[:, 0] >> kbits
        s = (pr & kmask).long()
    return ols.permute(2, 0, 1), ils.transpose(0, 1), init_ols


def _csr_decode_traced(ll, frame_mask, tabs: TierTables, hub_state_arr,
                       start: int, K: int, CB: int, CZ: int, n_eps: int,
                       beam: float, HC: int | None = None):
    """Decode + on-device traceback -> ([B, T, R] olabels, [B, T] tids,
    [B, R0] init olabels, [B] cost, [B] overflow, [B] saturated,
    [B] active-token sum, [B] active-token max)."""
    (init_recs, recs, il_emit, best_slot, best_cost, ovf, sat, act_sum,
     act_max) = _csr_decode(ll, frame_mask, tabs, hub_state_arr, start, K,
                            CB, CZ, n_eps, beam, HC)
    ols, ils, init_ols = _traceback(recs, il_emit, init_recs, best_slot, K)
    return ols, ils, init_ols, best_cost, ovf, sat, act_sum, act_max


def _csr_decode_rec(ll, frame_mask, tabs: TierTables, hub_state_arr,
                    start: int, K: int, CB: int, CZ: int, n_eps: int,
                    beam: float, HC: int | None, Kc: int, rec_beam: float,
                    rec_f16: bool, CAPB: int):
    """Record frame loop for lattice generation (kaldi_tpu `_csr_decode`,
    record_full=True): every round's frontier snapshot, compacted on the
    device, instead of back-pointers.

    The rounds keep the SCORE-sorted frontier (state_sort=False): the
    compaction's keep-mask and [:, :Kc] cut take the alive slots to be a
    score-sorted prefix. Each snapshot keeps the slots within rec_beam of
    the frame best and ships its first Kc slots; alive slots past Kc are
    counted in rec_trunc. With rec_f16 the scores are float16 relative to
    the frame best (masked slots +inf), else absolute f32 (masked BIG).

    CAPB > 0 selects flat records: each snapshot's alive prefix is packed
    into one [B, CAPB] buffer per utterance, a fixed Kc-slot window
    written at min(cursor, CAPB - Kc), the cursor advancing by the alive
    count on live frames only; `fovf` marks a window that had to be
    clipped. On frames past an utterance's end the reference writes its
    window at the cursor too, and when the cursor is within Kc of CAPB
    that window lands on the utterance's last live records without
    setting `fovf`. Here those rows write a spare window past CAPB
    instead, which is never read: live frames' records and `fovf` are
    the reference's.

    -> dict of device tensors (keys as kaldi_tpu's tuple, see
    CsrBeamDecoder.decode_raw_async)."""
    B, T, P = ll.shape
    dev = ll.device
    emit_round, eps_round = _rounds_for(tabs, hub_state_arr, B, K, CB, CZ,
                                        beam, HC, state_sort=False)
    R = 1 + n_eps
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rec_dtype = torch.float16 if rec_f16 else torch.float32
    flat = CAPB > 0

    def compact_rec(s, c):
        keep = c <= c[:, :1] + rec_beam
        n_alive = torch.sum(keep, dim=1, dtype=torch.int32)
        best = c[:, 0]
        if rec_f16:
            rel = torch.where(keep[:, :Kc], c[:, :Kc] - c[:, :1],
                              float("inf"))
            sc_out = rel.to(torch.float16)        # round to nearest even
        else:
            sc_out = torch.where(keep[:, :Kc], c[:, :Kc], float(BIG))
        return s[:, :Kc], sc_out, best, torch.clamp(n_alive - Kc, min=0), \
            n_alive

    tok_state, tok_score = _start_frontier(B, K, start, dev)
    st, sc = tok_state, tok_score
    init_full = []
    for _ in range(n_eps):
        st, sc, _rec, _il, _ovf = eps_round(st, sc)
        init_full.append((st, sc))
    tok_state, tok_score = st, sc

    ll_tb = ll.transpose(0, 1).contiguous()
    mask_tb = frame_mask.transpose(0, 1).contiguous()
    ovf_t = torch.empty((T, B), dtype=torch.int32, device=dev)
    sat_t = torch.empty((T, B), dtype=torch.bool, device=dev)
    nact_t = torch.empty((T, B), dtype=torch.int32, device=dev)
    trunc_t = torch.empty((T, B), dtype=torch.int32, device=dev)
    fbest = torch.empty((B, T, R), dtype=torch.float32, device=dev)
    if flat:
        dead = float("inf") if rec_f16 else float(BIG)
        fbst = torch.zeros((B, CAPB + Kc), dtype=torch.int32, device=dev)
        fbsc = torch.full((B, CAPB + Kc), dead, dtype=rec_dtype, device=dev)
        cursor = torch.zeros(B, dtype=torch.int64, device=dev)
        fovf = torch.zeros(B, dtype=torch.bool, device=dev)
        counts = torch.empty((B, T, R), dtype=torch.int32, device=dev)
        window = torch.arange(Kc, device=dev)[None, :]
    else:
        fst = torch.empty((B, T, R, Kc), dtype=torch.int32, device=dev)
        fsc = torch.empty((B, T, R, Kc), dtype=rec_dtype, device=dev)
    for f in range(T):
        mask_f = mask_tb[f]
        m = mask_f[:, None]
        st, sc, _rec, _il, ovf = emit_round(tok_state, tok_score, ll_tb[f])
        full = [(st, sc)]
        for _ in range(1, R):
            st, sc, _rec, _il, ovf_z = eps_round(st, sc)
            full.append((st, sc))
            ovf = ovf + ovf_z
        trunc = zero
        for r, (s, c) in enumerate(full):
            s_c, c_c, b_c, tr, n_alive = compact_rec(
                torch.where(m, s, tok_state), torch.where(m, c, tok_score))
            fbest[:, f, r] = b_c
            trunc = trunc + torch.where(mask_f, tr, zero)
            if flat:
                w = torch.where(mask_f, torch.clamp(n_alive, max=Kc), zero)
                fovf |= mask_f & (cursor > CAPB - Kc)
                safe = torch.where(mask_f, torch.clamp(cursor, max=CAPB - Kc),
                                   CAPB)
                idx = safe[:, None] + window
                fbst.scatter_(1, idx, s_c)
                fbsc.scatter_(1, idx, c_c)
                cursor = cursor + w
                counts[:, f, r] = w
            else:
                fst[:, f, r] = s_c
                fsc[:, f, r] = c_c
        trunc_t[f] = trunc
        _frame_stats(sc, mask_f, ovf, zero, ovf_t[f], sat_t[f], nact_t[f])
        tok_state = torch.where(m, st, tok_state)
        tok_score = torch.where(m, sc, tok_score)

    best_slot, best_cost = _best_final(tok_state, tok_score, tabs.final)
    if init_full:
        ic = [compact_rec(s, c) for (s, c) in init_full]
        ist = torch.stack([x[0] for x in ic], dim=1)
        isc = torch.stack([x[1] for x in ic], dim=1)
        ibest = torch.stack([x[2] for x in ic], dim=1)
        init_trunc = sum(x[3] for x in ic)
    else:
        ist = torch.zeros((B, 0, Kc), dtype=torch.int32, device=dev)
        isc = torch.zeros((B, 0, Kc), dtype=rec_dtype, device=dev)
        ibest = torch.zeros((B, 0), dtype=torch.float32, device=dev)
        init_trunc = zero
    out = dict(
        final_states=tok_state, final_scores=tok_score,
        best_slot=best_slot.to(torch.int32), best_cost=best_cost,
        overflow=torch.sum(ovf_t, dim=0, dtype=torch.int32),
        saturated=torch.any(sat_t, dim=0),
        init_states=ist, init_scores=isc, init_best=ibest,
        rec_trunc=torch.sum(trunc_t, dim=0, dtype=torch.int32) + init_trunc,
        active_sum=torch.sum(nact_t, dim=0, dtype=torch.int32),
        active_max=torch.amax(nact_t, dim=0), frame_best=fbest)
    if flat:
        out.update(counts=counts, flat_states=fbst[:, :CAPB],
                   flat_scores=fbsc[:, :CAPB], flat_overflow=fovf,
                   cursor=cursor)
    else:
        out.update(states=fst, scores=fsc)
    return out


def resolve_eps_rounds(graph: PackedGraph, requested: int | None) -> int:
    """Static non-emitting-closure round count for a graph
    (kaldi_tpu/decoder/beam_search.py `resolve_eps_rounds`): the exact
    eps-chain depth when it is boundable; a cyclic or >8-deep eps
    subgraph with no explicit override raises."""
    depth = eps_depth(graph)
    if depth is not None:
        return depth
    if requested is None:
        raise ValueError(
            "graph has cyclic (or >8-deep) epsilon chains: a static "
            "closure-round count cannot be inferred. Remove eps cycles "
            "(determinize/rmepsilon the graph) or set eps_expansions "
            "explicitly to accept truncated closure.")
    return requested


class CsrBeamDecoder:
    """Host wrapper: tier-pack the graph once onto `device` (the card
    unless the caller asks for "cpu"), decode utterance batches there."""

    def __init__(self, graph: PackedGraph, opts: CsrBeamOpts = CsrBeamOpts(),
                 device="cuda"):
        if graph.pdf is None:
            raise ValueError("PackedGraph has no tid->pdf mapping: the graph "
                             "must carry per-arc pdfs for decoding")
        self.device = resolve_device(device)
        if opts.fold_eps:
            folded = fold_epsilons(graph)
            if folded is not None:
                graph = folded     # eps rounds resolve to 0 below
        self.graph = graph
        opts = dataclasses.replace(
            opts,
            eps_expansions=resolve_eps_rounds(graph, opts.eps_expansions),
            expand_budget=max(opts.expand_budget, opts.max_active),
            eps_budget=max(opts.eps_budget, 256))
        self.opts = opts
        csr = split_csr(graph)
        self.csr = csr
        kbits = max((opts.max_active - 1).bit_length(), 1)
        if csr.max_olabel >= (1 << (31 - kbits)):
            raise ValueError(
                f"olabel range {csr.max_olabel} too large to pack with "
                f"max_active={opts.max_active}")
        self.tabs = build_tier_tables(csr, opts.hub_threshold,
                                      force_triple=opts.force_b_triple,
                                      device=self.device)
        t = self.tabs
        self._hub_state_arr = torch.as_tensor(
            t.hub_states.astype(np.int32) if t.hub_states.size
            else np.full(1, -1, np.int32), device=self.device)
        self.last_overflow: np.ndarray | None = None   # [B] dropped arcs
        self.last_saturated: np.ndarray | None = None  # [B] cap ever hit
        self.last_active_sum: np.ndarray | None = None  # [B] sum over
        #   frames of alive tokens (mean occupancy = sum / num_frames)
        self.last_active_max: np.ndarray | None = None  # [B] peak alive
        self.last_rec_trunc: np.ndarray | None = None   # [B] alive slots
        #   dropped by record compaction (decode_raw only)
        self.last_flat_fallbacks = 0    # batches re-decoded dense after
        #   a rec_flat buffer overflow (cumulative)

    @property
    def _hc(self):
        o = self.opts
        return None if o.hub_cap is None else int(o.hub_cap)

    def _search_args(self):
        o = self.opts
        return (self.tabs, self._hub_state_arr, int(self.csr.start),
                int(o.max_active), int(o.expand_budget), int(o.eps_budget),
                int(o.eps_expansions), float(o.beam), self._hc)

    def decode_async(self, loglikes, num_frames: np.ndarray):
        """Enqueue the decode + traceback on the device; returns a finisher
        producing per-utterance (words, tids, total_cost) or None — one
        device->host copy at finish time.

        loglikes: [B, T, P] f32 tensor (moved to the decoder's device) or
        numpy array."""
        o = self.opts
        ll = torch.as_tensor(loglikes).to(device=self.device,
                                          dtype=torch.float32)
        B, T, P = ll.shape
        nf = np.asarray(num_frames)
        mask = device_mask(nf, T, self.device)
        ll = ll * o.acoustic_scale
        outs = _csr_decode_traced(ll, mask, *self._search_args())

        def finish():
            (o_, i_, n_, c_, self.last_overflow, self.last_saturated,
             self.last_active_sum, self.last_active_max) = fetch_host(
                 list(outs))
            return parse_label_seqs(o_, i_, n_, c_, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()

    def decode_raw_async(self, loglikes, num_frames: np.ndarray):
        """Enqueue a record decode for lattice generation; returns a
        finisher producing the record dict, with ONE blocking
        device->host copy of every record tensor at finish time (int32,
        float16 and float32 packed into one buffer). The host enqueues
        the whole frame loop here; the device runs behind it, so a caller
        can enqueue the next batch before finishing this one.

        loglikes: [B, T, P] numpy array or tensor. The scaled loglikes
        stay a host numpy array in the result (`ll_scaled`), as the
        extractors read them there."""
        o = self.opts
        if torch.is_tensor(loglikes):
            loglikes = loglikes.detach().cpu().numpy()
        ll_scaled = np.asarray(loglikes) * o.acoustic_scale
        B, T, P = ll_scaled.shape
        nf = np.asarray(num_frames)
        mask = device_mask(nf, T, self.device)
        Kc = min(o.rec_cap or o.max_active, o.max_active)
        rec_beam = o.rec_beam if o.rec_beam is not None else o.beam
        R = 1 + int(o.eps_expansions)
        CAPB = max(int(o.rec_flat_cap) * T * R, 2 * Kc) if o.rec_flat \
            else 0
        ll = torch.as_tensor(ll_scaled).to(device=self.device,
                                           dtype=torch.float32)
        out = _csr_decode_rec(ll, mask, *self._search_args(), Kc=Kc,
                              rec_beam=float(rec_beam),
                              rec_f16=bool(o.rec_f16), CAPB=CAPB)
        names = list(out)

        def fetch():
            return dict(zip(names, fetch_host([out[n] for n in names])))

        def expand(sc, best):
            """f16 scores relative to the round best -> absolute f32
            (masked +inf slots back to BIG); f32 scores as they are."""
            if not o.rec_f16:
                return sc
            sc = sc.astype(np.float32) + best[..., None]
            return np.where(np.isfinite(sc), sc, np.float32(BIG))

        def counters(h):
            self.last_overflow = h["overflow"]
            self.last_saturated = h["saturated"]
            self.last_rec_trunc = h["rec_trunc"]
            self.last_active_sum = h["active_sum"]
            self.last_active_max = h["active_max"]

        def result(h, states, scores, **extra):
            return dict(init_states=h["init_states"],
                        init_scores=expand(h["init_scores"],
                                           h["init_best"]),  # [B, R0, Kc]
                        states=states, scores=scores,        # [B, T, R, K']
                        final_states=h["final_states"],      # [B, K]
                        final_scores=h["final_scores"],
                        best_slot=h["best_slot"], best_cost=h["best_cost"],
                        rec_trunc=h["rec_trunc"], **extra,
                        ll_scaled=ll_scaled)

        def finish():
            h = fetch()
            counters(h)
            return result(h, h["states"], expand(h["scores"],
                                                 h["frame_best"]))

        def finish_flat():
            h = fetch()
            if h["flat_overflow"].any():
                # the flat buffer overflowed for some utterance: redo this
                # batch with dense records (exact, more bytes on the copy)
                # and count the event
                self.last_flat_fallbacks += int(h["flat_overflow"].sum())
                saved = self.opts
                self.opts = dataclasses.replace(o, rec_flat=False)
                try:
                    return self.decode_raw_async(loglikes, nf)()
                finally:
                    self.opts = saved
            counters(h)
            # rebuild the dense [B, T, R, Keff] view from the packed alive
            # prefixes (Keff = the widest snapshot)
            counts, fbest = h["counts"], h["frame_best"]
            Keff = max(int(counts.max()), 1)
            fst = np.zeros((B, T * R, Keff), np.int32)
            fsc = np.full((B, T * R, Keff), BIG, np.float32)
            for b in range(B):
                cb = counts[b].reshape(-1).astype(np.int64)
                off = np.concatenate([[0], np.cumsum(cb)])
                tot = int(off[-1])
                rows = np.repeat(np.arange(T * R), cb)
                ks = np.arange(tot) - off[:-1].repeat(cb)
                fst[b, rows, ks] = h["flat_states"][b, :tot]
                sc = h["flat_scores"][b, :tot].astype(np.float32)
                if o.rec_f16:
                    sc = sc + fbest[b].reshape(-1)[rows]
                fsc[b, rows, ks] = sc
            return result(h, fst.reshape(B, T, R, Keff),
                          fsc.reshape(B, T, R, Keff),
                          rec_wire_slots=int(h["cursor"].sum()))

        return finish_flat if o.rec_flat else finish

    def decode_raw(self, loglikes, num_frames: np.ndarray):
        """Record decode for lattice generation: a dict of per-round
        frontier snapshots (states/scores), the input of
        kaldi_tpu_torch.lat.generate.raw_lattice_from_decode."""
        return self.decode_raw_async(loglikes, num_frames)()


def _csr_chunk_step(tok_state, tok_score, arena, ilar, ll_tb, mask_tb, t0: int,
                    rounds, self_prev):
    """One chunk of the incremental decode (kaldi_tpu `_csr_chunk_step`):
    advance the carried frontier over the frames of ll_tb [Tc, B, P],
    writing their back-pointer records into the arena [Tp, R, B, K] and
    the il array [Tp, B, K] in place from frame t0 on. -> (tok_state,
    tok_score, flags [4, B] int32: saturated in any frame, dropped arcs,
    active-token sum, active-token max)."""
    tok_state, tok_score, ovf_t, sat_t, nact_t = _frame_loop(
        rounds, tok_state, tok_score, ll_tb, mask_tb, arena, ilar, t0,
        self_prev)
    flags = torch.stack([torch.any(sat_t, dim=0).to(torch.int32),
                         torch.sum(ovf_t, dim=0, dtype=torch.int32),
                         torch.sum(nact_t, dim=0, dtype=torch.int32),
                         torch.amax(nact_t, dim=0)])
    return tok_state, tok_score, flags


class ChunkedCsrBeamDecoder:
    """Incremental offline decode (kaldi_tpu's ChunkedCsrBeamDecoder): the
    batch advances in Tc-frame chunks with the frontier and the
    back-pointer arena resident on the device, so the host sees each
    chunk's saturation / overflow flags (a few bytes) while the search
    runs, and a caller can stop the decode between chunks. The per-frame
    step is the best-path program's, so chunked == one-shot exactly.

    The flags of chunk c are copied without blocking into pinned host
    memory behind an event; the host reads them after it has enqueued
    chunk c + 1, so it never waits on the chunk it just enqueued. It runs
    on `device` (the card unless the caller asks for "cpu")."""

    def __init__(self, graph: PackedGraph,
                 opts: CsrBeamOpts = CsrBeamOpts(),
                 chunk_frames: int = 128, device="cuda"):
        self._dec = CsrBeamDecoder(graph, opts, device=device)
        self.device = self._dec.device
        self.graph = graph
        self.opts = self._dec.opts
        self.Tc = int(chunk_frames)
        self.tabs = self._dec.tabs
        self.last_overflow: np.ndarray | None = None
        self.last_saturated: np.ndarray | None = None
        self.last_active_sum: np.ndarray | None = None
        self.last_active_max: np.ndarray | None = None
        self.chunks_run = 0          # chunks executed by the last decode
        self.aborted = False

    def decode_async(self, loglikes, num_frames: np.ndarray,
                     stop_when=None):
        """Chunked decode. stop_when: optional callable
        (sat_cum [B] bool, ovf_cum [B] int) -> bool evaluated after each
        chunk's flags arrive; True aborts the remaining chunks (results
        are then only meaningful for the caller's escalation logic).
        Returns a finisher -> per-utterance (words, tids, cost)."""
        o = self.opts
        dev = self.device
        K = int(o.max_active)
        ll = torch.as_tensor(loglikes).to(device=dev, dtype=torch.float32)
        B, T, P = ll.shape
        Tc = self.Tc
        n_chunks = -(-T // Tc)
        Tp = n_chunks * Tc
        nf = np.asarray(num_frames)
        # [Tp, B, P]: each frame's [B, P] kernel table is contiguous
        ll_tb = torch.zeros((Tp, B, P), dtype=torch.float32, device=dev)
        ll_tb[:T] = (ll * o.acoustic_scale).transpose(0, 1)
        mask_tb = device_mask(nf, Tp, dev).transpose(0, 1).contiguous()
        R = 1 + int(o.eps_expansions)
        (tabs, hub_state_arr, start, _K, CB, CZ, n_eps, beam,
         HC) = self._dec._search_args()
        rounds = _rounds_for(tabs, hub_state_arr, B, K, CB, CZ, beam, HC,
                             state_sort=True)

        # the start frontier and its eps records (once)
        st, sc, init_recs = _start_rounds(rounds[1], B, K, start, n_eps, dev)
        self_prev = torch.arange(K, dtype=torch.int32,
                                 device=dev)[None, :].expand(B, K)
        # untouched rows are identity records, so the traceback needs no
        # frame gating (also after an abort)
        arena = self_prev[None, None].expand(Tp, R, B, K).clone()
        ilar = torch.zeros((Tp, B, K), dtype=torch.int32, device=dev)

        cuda = dev.type == "cuda"
        if cuda:
            host_flags = torch.empty((n_chunks, 4, B), dtype=torch.int32,
                                     pin_memory=True)
            stream = torch.cuda.current_stream(dev)

        def send(c, flags):
            if not cuda:
                return flags
            host_flags[c].copy_(flags, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            return ev

        def receive(c, sent):
            if not cuda:
                return sent.numpy()
            sent.synchronize()
            return host_flags[c].numpy()

        sat_cum = np.zeros(B, bool)
        ovf_cum = np.zeros(B, np.int64)
        act_sum = np.zeros(B, np.int64)
        act_max = np.zeros(B, np.int64)
        self.chunks_run = 0

        def absorb(c, sent):
            s_, o_, asum, amax = receive(c, sent)
            sat_cum[:] |= s_.astype(bool)
            ovf_cum[:] += o_
            act_sum[:] += asum
            np.maximum(act_max, amax, out=act_max)

        pending = None      # (chunk index, its flags on their way)
        aborted = False
        for c in range(n_chunks):
            lo = c * Tc
            st, sc, flags = _csr_chunk_step(
                st, sc, arena, ilar, ll_tb[lo:lo + Tc], mask_tb[lo:lo + Tc],
                lo, rounds, self_prev)
            self.chunks_run += 1
            sent = send(c, flags)
            # the PREVIOUS chunk's flags, read while this one runs
            if pending is not None:
                absorb(*pending)
                if stop_when is not None and stop_when(sat_cum, ovf_cum):
                    aborted = True
                    break
            pending = (c, sent)
        if pending is not None and not aborted:
            absorb(*pending)
            if stop_when is not None and stop_when(sat_cum, ovf_cum):
                aborted = True
        self.aborted = aborted

        best_slot, cost = _best_final(st, sc, tabs.final)
        ols, ils, init_ols = _traceback(arena, ilar, init_recs, best_slot, K)

        def finish():
            o_, i_, n_, c_ = fetch_host([ols, ils, init_ols, cost])
            self.last_overflow = ovf_cum
            self.last_saturated = sat_cum
            self.last_active_sum = act_sum
            self.last_active_max = act_max
            return parse_label_seqs(o_, i_, n_, c_, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()


class AdaptiveCsrBeamDecoder:
    """Two-tier decode (kaldi_tpu's AdaptiveCsrBeamDecoder): a SMALL
    max_active program runs chunked and aborts once every utterance has
    saturated its frontier or overflowed its budget; those utterances are
    re-decoded with the full-capacity program. Results equal decoding
    everything at full_opts.max_active: where the small frontier never
    fills, its search is the full one's. The loglikes stay on the device,
    and the escalated subset is taken from them with index_select. Runs
    on `device` (the card unless the caller asks for "cpu")."""

    def __init__(self, graph: PackedGraph,
                 full_opts: CsrBeamOpts = CsrBeamOpts(),
                 small_max_active: int = 1024,
                 small_expand_budget: int | None = None,
                 chunk_frames: int = 128, device="cuda"):
        self.full = CsrBeamDecoder(graph, full_opts, device=device)
        self.device = self.full.device
        small = dataclasses.replace(
            full_opts, max_active=small_max_active,
            expand_budget=(small_expand_budget
                           or max(small_max_active * 4, 4096)))
        self.small = ChunkedCsrBeamDecoder(graph, small,
                                           chunk_frames=chunk_frames,
                                           device=self.device)
        self.graph = graph
        self.opts = full_opts
        self.last_escalated: np.ndarray | None = None   # [B] bool
        self.last_small_chunks = 0   # chunks the small program executed

    def decode_async(self, loglikes, num_frames: np.ndarray):
        nf = np.asarray(num_frames)
        ll_dev = torch.as_tensor(loglikes).to(device=self.device,
                                              dtype=torch.float32)
        fin_small = self.small.decode_async(
            ll_dev, nf,
            stop_when=lambda sat, ovf: bool((sat | (ovf > 0)).all()))

        def finish():
            res = fin_small()
            self.last_small_chunks = self.small.chunks_run
            redo = (self.small.last_saturated.astype(bool)
                    | (self.small.last_overflow > 0))
            self.last_escalated = redo
            if redo.all():
                # the whole batch escalates: the full program at batch B
                return self.full.decode(ll_dev, nf)
            if redo.any():
                idx = np.flatnonzero(redo)
                ll_sub = ll_dev.index_select(
                    0, torch.as_tensor(idx, device=self.device))
                res_big = self.full.decode(ll_sub, nf[idx])
                for j, b in enumerate(idx):
                    res[b] = res_big[j]
            return res

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()
