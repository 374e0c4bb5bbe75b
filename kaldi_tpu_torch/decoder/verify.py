"""Static verification of packed decode graphs (the batched decoder's
index programs are gather-heavy; a malformed graph would read garbage
silently on TPU, where there is no bounds checking).

(ref: SURVEY.md §5 'race detection/sanitizers' — the reference's
 nnet3 ComputationChecker (nnet3/nnet-analyze.h:370-394) validates its
 compiled programs before execution; this is the same idea for our
 PackedGraph CSR tables.)

Counterpart of kaldi_tpu/decoder/verify.py. `check_packed_graph` is a
host copy. `check_tier_tables` reads the port's `TierTables`, whose fields
are torch tensors on their device: the four tables come to the host in
one copy, and the tier-B padding check is vectorised (JAX's loops over
every tier-B state), raising on exactly the same tables.
"""

from __future__ import annotations

import numpy as np
import torch


def check_packed_graph(graph, num_pdfs: int | None = None) -> None:
    """Raise ValueError on any inconsistency; silent on a valid graph.

    Checks: CSR monotonicity and coverage, next-state bounds, start/final
    validity, emitting arcs carry a valid pdf (and pdf < num_pdfs when
    given), eps arcs carry pdf -1, emitting-before-eps arc ordering per
    state (the _pad_csr/packing contract).
    """
    S = graph.num_states
    A = len(graph.ilabel)
    errs = []
    a0 = np.asarray(graph.arc_start)
    if len(a0) != S + 1:
        errs.append(f"arc_start length {len(a0)} != num_states+1 {S + 1}")
    else:
        if a0[0] != 0 or a0[-1] != A:
            errs.append("arc_start does not span [0, num_arcs]")
        if (np.diff(a0) < 0).any():
            errs.append("arc_start not monotonically nondecreasing")
    for name in ("ilabel", "olabel", "cost", "nextstate"):
        if len(getattr(graph, name)) != A:
            errs.append(f"{name} length != num_arcs")
    nxt = np.asarray(graph.nextstate)
    if A and ((nxt < 0) | (nxt >= S)).any():
        errs.append("nextstate out of range")
    if not (0 <= graph.start < S):
        errs.append(f"start state {graph.start} out of range")
    fin = np.asarray(graph.final)
    if len(fin) != S:
        errs.append("final length != num_states")
    elif not np.isfinite(fin).any():
        errs.append("no reachable final state (all finals infinite)")
    il = np.asarray(graph.ilabel)
    if graph.pdf is not None:
        pdf = np.asarray(graph.pdf)
        if len(pdf) != A:
            errs.append("pdf length != num_arcs")
        else:
            emit = il > 0
            if (pdf[emit] < 0).any():
                errs.append("emitting arc with pdf < 0")
            if num_pdfs is not None and A and (pdf[emit] >= num_pdfs).any():
                errs.append(f"emitting arc pdf >= num_pdfs ({num_pdfs})")
            if (pdf[~emit] != -1).any():
                errs.append("eps arc with pdf != -1")
    # per-state emitting-before-eps ordering (packing contract) — O(A)
    # vectorized: an eps->emitting transition inside a state is a
    # violation; transitions that cross a state boundary are exempt
    if len(a0) == S + 1 and not errs and A > 1:
        is_eps = (il == 0).astype(np.int8)
        bad = np.diff(is_eps) < 0                   # eps then emitting
        boundary = np.zeros(A - 1, bool)
        starts = a0[1:-1]                           # interior boundaries
        boundary[starts[(starts > 0) & (starts < A)] - 1] = True
        viol = np.where(bad & ~boundary)[0]
        if len(viol):
            s = int(np.searchsorted(a0, viol[0], side="right") - 1)
            errs.append(
                f"state {s}: eps arc before an emitting arc "
                "(emitting-first packing violated)")
    if errs:
        raise ValueError("packed graph verification failed:\n  "
                         + "\n  ".join(errs))


def check_tier_tables(graph, tabs, hub_threshold: int) -> None:
    """Static verification of the CSR decoder's tier partition (the
    ComputationChecker role for the degree-tiered layout): every emitting
    arc of the graph must live in exactly one tier, tier-A rows must
    mirror the CSR arcs of deg<=2 states, tier-B offsets/degrees must
    index brow consistently, and hub bounds must partition hub_rows.

    Raises ValueError with all violations; silent when consistent.
    """
    from kaldi_tpu_torch.decoder.graph_pack import split_csr

    errs = []
    csr = split_csr(graph)
    S = csr.num_states
    e_deg = np.diff(csr.estart)
    srow, zrow, brow, hub_rows = _host_tables(
        (tabs.srow, tabs.zrow, tabs.brow, tabs.hub_rows))
    is_hub = e_deg > hub_threshold
    tier_a = (~is_hub) & (e_deg <= 2)
    tier_b = (~is_hub) & (e_deg > 2)
    BIG_BITS = int(np.array(1e10, np.float32).view(np.int32))

    # arc conservation: tierA slots + tierB degs + hub rows == all arcs
    n_a = int((srow[:, 0] != BIG_BITS).sum()
              + (srow[:, 5] != BIG_BITS).sum())
    n_b = int(srow[:, 11].sum())
    n_hub = int(hub_rows.shape[0]) if len(tabs.hub_bounds) > 1 else 0
    total = len(csr.e_nxt)
    if n_a + n_b + n_hub != total:
        errs.append(f"emitting arcs not partitioned: tierA {n_a} + "
                    f"tierB {n_b} + hub {n_hub} != {total}")
    # tier-A rows mirror the CSR in EVERY field
    cost_bits = csr.e_cost.view(np.int32)
    for j in (0, 1):
        has = tier_a & (e_deg > j)
        a = csr.estart[:-1][has] + j
        base = 5 * j
        for (col, ref, what) in ((0, cost_bits, "cost"),
                                 (1, csr.e_nxt, "nextstate"),
                                 (2, csr.e_pdf, "pdf"),
                                 (3, csr.e_tid, "tid"),
                                 (4, csr.e_ol, "olabel")):
            if not (srow[has, base + col] == ref[a]).all():
                errs.append(f"tier-A arc {j}: {what} mismatch")
    if (srow[tier_b, 11] != e_deg[tier_b]).any():
        errs.append("tier-B degree mismatch")
    if tier_b.any():
        # packed layout (see csr_beam.TierTables): ceil(deg/apr) rows
        # per state, arc i at row (row_off + i//apr); quad (apr=4) packs
        # (cost, nxt, pdf|tid<<16, ol) at col 4*(i%4), triple (apr=3)
        # packs full lanes at col 5*(i%3); padding arcs carry cost=BIG
        apr = int(getattr(tabs, "b_apr", 3))
        b_rows = -(-e_deg[tier_b] // apr)
        ends = srow[tier_b, 10].astype(np.int64) + b_rows
        if ends.max(initial=0) > brow.shape[0]:
            errs.append("tier-B offsets overrun brow")
        else:
            # full content mirror of the packed tier-B arcs
            bs = np.flatnonzero(tier_b)
            reps = e_deg[bs]
            AB = int(reps.sum())
            offs = np.repeat(csr.estart[:-1][bs].astype(np.int64), reps)
            starts = np.repeat(srow[bs, 10].astype(np.int64), reps)
            within = np.arange(AB) - np.repeat(
                np.cumsum(reps) - reps, reps)
            src_idx = offs + within
            rows_idx = starts + within // apr
            if apr == 4:
                colb = 4 * (within % 4)
                pt = (csr.e_pdf[src_idx].astype(np.uint32)
                      | (csr.e_tid[src_idx].astype(np.uint32)
                         << np.uint32(16))).view(np.int32)
                fields = ((0, cost_bits[src_idx], "cost"),
                          (1, csr.e_nxt[src_idx], "nextstate"),
                          (2, pt, "pdf|tid"),
                          (3, csr.e_ol[src_idx], "olabel"))
            else:
                colb = 5 * (within % 3)
                fields = ((0, cost_bits[src_idx], "cost"),
                          (1, csr.e_nxt[src_idx], "nextstate"),
                          (2, csr.e_pdf[src_idx], "pdf"),
                          (3, csr.e_tid[src_idx], "tid"),
                          (4, csr.e_ol[src_idx], "olabel"))
            for (col, ref, what) in fields:
                if not (brow[rows_idx, colb + col] == ref).all():
                    errs.append(f"tier-B rows: {what} mismatch")
            # padding arcs of partially-filled last rows must be dead
            n_pad = int((apr * b_rows - e_deg[tier_b]).sum())
            if n_pad:
                lane_w = 4 if apr == 4 else 5
                pad_deg = apr * b_rows - e_deg[tier_b]
                first = np.repeat(e_deg[tier_b].astype(np.int64), pad_deg)
                i = first + np.arange(n_pad) - np.repeat(
                    np.cumsum(pad_deg) - pad_deg, pad_deg)
                pad_rows = np.repeat(srow[tier_b, 10].astype(np.int64),
                                     pad_deg) + i // apr
                pad_cols = lane_w * (i % apr)
                if (brow[pad_rows, pad_cols] != BIG_BITS).any():
                    errs.append("tier-B rows: padding arc not dead")
    if is_hub.any():
        hb = tabs.hub_bounds
        if list(hb) != sorted(hb):
            errs.append("hub bounds not monotone")
        if hb[-1] != hub_rows.shape[0]:
            errs.append("hub bounds do not span hub_rows")
        if len(hb) - 1 != int(is_hub.sum()):
            errs.append("hub count mismatch")
    # eps tier-A rows mirror the eps CSR
    z_deg = np.diff(csr.zstart)
    z_a = z_deg <= 2
    for j in (0, 1):
        has = z_a & (z_deg > j)
        a = csr.zstart[:-1][has] + j
        if not (zrow[has, 3 * j + 1] == csr.z_nxt[a]).all():
            errs.append(f"eps tier-A arc {j}: nextstate mismatch")
    if errs:
        raise ValueError("tier table verification failed:\n  "
                         + "\n  ".join(errs))


def _host_tables(tables) -> list[np.ndarray]:
    """int32 device tensors -> numpy arrays of the same shapes, in one
    device->host copy (a host tensor is only viewed)."""
    tables = [torch.as_tensor(t) for t in tables]
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tables])
    host = flat.cpu().numpy()
    out, lo = [], 0
    for t in tables:
        n = t.numel()
        out.append(host[lo: lo + n].reshape(tuple(t.shape)))
        lo += n
    return out
