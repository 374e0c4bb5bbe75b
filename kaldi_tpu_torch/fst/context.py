"""Triphone (N-phone) context expansion: CLG = C ∘ LG built on the fly.

(ref: fstext/context-fst.h:83-215 ContextFst / :491-507 ComposeContext,
 fstbin/fstcomposecontext.cc.) The C transducer is never materialized;
 we traverse LG carrying the last N-1 phones as state context and emit
 context-window input labels with the standard one-phone delay (windows
 need their right context). Out-of-utterance positions are phone 0; the
 pending last phone is flushed at final states (the role of the
 subsequential '$' symbol in the reference).

ilabel_info convention (shared with make_h_transducer): entry 0 = [],
[-sym] for disambig passthrough, [0] for the #-1 "empty window" symbol,
else the N-length phone window.

The port's copy of kaldi_tpu/fst/context.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

from kaldi_tpu_torch.fst.fst import Fst, EPS, INF


def compose_context(
    lg: Fst,
    disambig_in: set,
    N: int = 3,
    P: int = 1,
):
    """-> (clg, ilabel_info). Currently supports P == N-2 or generic central
    position with delay = N-1-P (windows emitted once right context known).
    """
    assert 0 <= P < N
    delay = N - 1 - P

    ilabel_info: list[list[int]] = [[]]
    ilabel_id: dict[tuple, int] = {(): 0}

    def get_ilabel(key: tuple) -> int:
        i = ilabel_id.get(key)
        if i is None:
            i = len(ilabel_info)
            ilabel_id[key] = i
            ilabel_info.append(list(key))
        return i

    # special "#-1" empty-window symbol used before enough phones are seen
    EMPTY = get_ilabel((0,))  # ilabel_info [0], like the reference's #-1

    out = Fst()
    # state: (lg_state, hist) where hist = last up-to-(N-1) phones, padded
    # left with 0; pending = phones not yet emitted as window centers
    state_map: dict = {}
    from collections import deque
    queue: deque = deque()

    def get_state(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    init_hist = (0,) * (N - 1)
    out.start = get_state((lg.start, init_hist, 0))
    # third component: number of pending phones (< delay at start/boundary)

    while queue:
        key = queue.popleft()
        lg_s, hist, pending = key
        cur = state_map[key]
        # final: flush pending phones with right-boundary zeros
        fw = lg.final(lg_s)
        if fw < INF:
            h, p = hist, pending
            src = cur
            cost = fw
            while p > 0:
                window = tuple(h) + (0,)
                ilab = get_ilabel(window)
                nh = tuple(h[1:]) + (0,)
                nxt = out.add_state()
                out.add_arc(src, ilab, EPS, cost, nxt)
                cost = 0.0
                src = nxt
                h, p = nh, p - 1
            out.set_final(src, cost)
        for (i, o, w, dst) in lg.arcs[lg_s]:
            if i == EPS:
                out.add_arc(cur, EPS, o, w, get_state((dst, hist, pending)))
            elif i in disambig_in:
                ilab = get_ilabel((-i,))
                out.add_arc(cur, ilab, o, w, get_state((dst, hist, pending)))
            else:
                # consume phone i
                new_hist = tuple(hist[1:]) + (i,)
                if pending < delay:
                    # not enough right context yet: emit empty symbol
                    out.add_arc(cur, EMPTY, o, w,
                                get_state((dst, new_hist, pending + 1)))
                else:
                    window = tuple(hist) + (i,)
                    ilab = get_ilabel(window)
                    out.add_arc(cur, ilab, o, w,
                                get_state((dst, new_hist, pending)))
    out.connect()
    out.arcsort("ilabel")
    return out, ilabel_info


def make_context_fst(phones: list, disambig: set, subseq_sym: int,
                     N: int = 3, P: int = 1):
    """Standalone context transducer C over ALL phone contexts:
    -> (C, ilabel_info), where compose(C, add_subsequential_loop(LG))
    equals compose_context(LG) (ref: fstbin/fstmakecontextfst.cc,
    fstext/context-fst.h ContextFst — the dynamic version above is what
    graph builds use; this enumerates every history, O(|phones|^{N-1})
    states).

    Input side: context windows (ilabel_info convention shared with
    compose_context). Output side: phones; the subsequential symbol
    flushes the delay = N-1-P pending phones at the end."""
    assert 0 <= P < N
    delay = N - 1 - P

    ilabel_info: list[list[int]] = [[]]
    ilabel_id: dict[tuple, int] = {(): 0}

    def get_ilabel(key: tuple) -> int:
        i = ilabel_id.get(key)
        if i is None:
            i = len(ilabel_info)
            ilabel_id[key] = i
            ilabel_info.append(list(key))
        return i

    EMPTY = get_ilabel((0,))
    out = Fst()
    from collections import deque
    state_map: dict = {}
    queue: deque = deque()

    def get_state(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    out.start = get_state(((0,) * (N - 1), 0))
    while queue:
        key = queue.popleft()
        hist, pending = key
        cur = state_map[key]
        if pending == 0:
            out.set_final(cur, 0.0)
        for d in sorted(disambig):
            out.add_arc(cur, get_ilabel((-d,)), d, 0.0, cur)
        for p in phones:
            nh = tuple(hist[1:]) + (p,)
            if pending < delay:
                out.add_arc(cur, EMPTY, p, 0.0, get_state((nh, pending + 1)))
            else:
                out.add_arc(cur, get_ilabel(tuple(hist) + (p,)), p, 0.0,
                            get_state((nh, pending)))
        if pending > 0:
            # subsequential symbol: flush one pending phone
            out.add_arc(cur, get_ilabel(tuple(hist) + (0,)), subseq_sym,
                        0.0, get_state((tuple(hist[1:]) + (0,),
                                        pending - 1)))
    out.arcsort("ilabel")
    return out, ilabel_info
