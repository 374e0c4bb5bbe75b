"""H-transducer construction and self-loop insertion.

(ref: hmm/hmm-utils.cc:30-160 GetHmmAsFst, :448-585 AddSelfLoops{Before,After},
 bin/make-h-transducer.cc, bin/add-self-loops.cc.)

Ha maps transition-ids (no self-loops) -> context-window symbols; after
composing/determinizing with CLG and removing disambig symbols, AddSelfLoops
expands each state with its self-loop transition-id, preserving
stochasticity by folding log(1 - p_selfloop) into outgoing arcs.

The port's copy of kaldi_tpu/fst/hmm_graph.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import math

from kaldi_tpu_torch.fst.fst import Fst, EPS, INF
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree.context_dep import ContextDependency


def get_hmm_as_fst(
    phone_window,
    ctx_dep: ContextDependency,
    trans_model: TransitionModel,
    transition_scale: float = 1.0,
) -> Fst:
    """Per-context-window HMM as an FST WITHOUT self-loops.

    Arc ilabels/olabels are transition-ids; cost is
    -transition_scale * log p(trans | not-self-loop).
    (ref: hmm-utils.cc:30-160 GetHmmAsFst)
    """
    topo = trans_model.topo
    P = ctx_dep.central_position
    phone = phone_window[P]
    entry = topo.entry(phone)
    pdfs = [ctx_dep.compute(phone_window, c)
            for c in range(topo.num_pdf_classes(phone))]

    f = Fst()
    states = [f.add_state() for _ in entry]
    f.start = states[0]
    f.set_final(states[-1], 0.0)
    for hmm_state, st in enumerate(entry):
        for trans_idx, (dst, prob) in enumerate(st.transitions):
            if dst == hmm_state:
                continue  # self-loops added later
            if st.pdf_class is None:
                log_prob = math.log(prob)
                label = EPS
            else:
                pdf = pdfs[st.pdf_class]
                ts = trans_model.tuple_to_transition_state(phone, hmm_state, pdf)
                tid = trans_model.pair_to_transition_id(ts, trans_idx)
                log_prob = trans_model.transition_log_prob_ignoring_self_loops(tid)
                label = tid
            f.add_arc(states[hmm_state], label, label,
                      -log_prob * transition_scale, states[dst])
    from kaldi_tpu_torch.fst.epsilon import remove_eps_local
    remove_eps_local(f)
    return f


def make_h_transducer(
    ilabel_info,
    ctx_dep: ContextDependency,
    trans_model: TransitionModel,
    transition_scale: float = 1.0,
):
    """Build Ha: transition-ids -> ilabel-ids (context windows).

    ilabel_info: list where entry k describes CLG's input symbol k:
      [] for eps, [-disambig_sym] for a disambig symbol, else the phone
      context window (ref: fstext/context-fst.h ilabel_info convention).
    Returns (Ha, disambig_tids): disambig symbols are assigned fresh fake
    transition-ids above the real range, to be stripped later.
    (ref: bin/make-h-transducer.cc)
    """
    f = Fst()
    loop = f.add_state()
    f.start = loop
    f.set_final(loop, 0.0)
    disambig_tids = []
    next_fake = trans_model.num_transition_ids + 1
    cache: dict = {}
    for k, info in enumerate(ilabel_info):
        if k == 0 or len(info) == 0:
            continue
        if len(info) == 1 and info[0] <= 0:
            # disambiguation symbol (or the #-1 empty-window symbol from
            # context composition): passthrough arc with a fake tid
            f.add_arc(loop, next_fake, k, 0.0, loop)
            disambig_tids.append(next_fake)
            next_fake += 1
            continue
        key = tuple(info)
        hmm = cache.get(key)
        if hmm is None:
            hmm = get_hmm_as_fst(list(info), ctx_dep, trans_model,
                                 transition_scale)
            cache[key] = hmm
        # splice hmm between loop -(olabel k on first arc)-> ... -> loop
        offset = f.num_states
        for _ in range(hmm.num_states):
            f.add_state()
        # arc from loop into the hmm start, emitting k (input eps)
        f.add_arc(loop, EPS, k, 0.0, offset + hmm.start)
        for s in range(hmm.num_states):
            for (i, o, w, d) in hmm.arcs[s]:
                f.add_arc(offset + s, i, EPS, w, offset + d)
            fw = hmm.final(s)
            if fw < INF:
                f.add_arc(offset + s, EPS, EPS, fw, loop)
    from kaldi_tpu_torch.fst.epsilon import remove_eps_local
    remove_eps_local(f)
    return f, disambig_tids


def _tid_class(trans_model: TransitionModel, disambig_tids, label: int) -> int:
    """Map arc ilabel -> transition-state (0 for eps/disambig)."""
    if label == EPS or label in disambig_tids:
        return 0
    return int(trans_model.id2state[label])


def _make_preceding_input_classes_same(fst: Fst, classof) -> None:
    """Duplicate states so all arcs INTO a state share one ilabel class.

    (ref: fstext/fstext-utils-inl.h MakePrecedingInputSymbolsSameClass)
    """
    n = fst.num_states
    # class entering each state
    seen: dict[int, dict[int, int]] = {}  # state -> class -> dup state
    in_class: list[int | None] = [None] * n
    # first pass: collect classes per state. The start state is virtually
    # entered by epsilon (class 0): if real-class arcs also enter it, it
    # must be duplicated so the original start keeps class 0 — otherwise
    # add_self_loops would put a self-loop (and forward-prob scaling) on
    # the start state before any emitting arc was consumed
    # (ref: fstext-utils-inl.h MakePrecedingInputSymbolsSameClass with
    # start_is_epsilon, as called from AddSelfLoops).
    classes: list[set] = [set() for _ in range(n)]
    if fst.start >= 0:
        classes[fst.start].add(0)
    for s in range(n):
        for (i, _o, _w, d) in fst.arcs[s]:
            classes[d].add(classof(i))
    # states needing duplication
    for s in range(n):
        cs = sorted(classes[s])
        if len(cs) <= 1:
            continue
        dups = {cs[0]: s}
        for c in cs[1:]:
            ns = fst.add_state()
            dups[c] = ns
            # copy outgoing arcs and final weight
            fst.arcs[ns] = list(fst.arcs[s])
            if s in fst.finals:
                fst.finals[ns] = fst.finals[s]
        seen[s] = dups
    # retarget incoming arcs
    for s in range(fst.num_states):
        new_arcs = []
        for (i, o, w, d) in fst.arcs[s]:
            if d in seen:
                d = seen[d][classof(i)]
            new_arcs.append((i, o, w, d))
        fst.arcs[s] = new_arcs


def add_self_loops(
    fst: Fst,
    trans_model: TransitionModel,
    disambig_tids=(),
    self_loop_scale: float = 1.0,
    reorder: bool = True,
) -> Fst:
    """Insert self-loop transition-ids (ref: hmm-utils.cc:573 AddSelfLoops).

    reorder=True ("dan-style"): the self-loop lives on the DESTINATION state
    of each emitting arc; all outgoing arcs/finals of that state are scaled
    by (1 - p_selfloop)^self_loop_scale.
    """
    dset = set(disambig_tids)
    classof = lambda i: _tid_class(trans_model, dset, i)
    if not reorder:
        raise NotImplementedError("only reorder=True (the recipe default)")
    _make_preceding_input_classes_same(fst, classof)
    n = fst.num_states
    state_in: list[int | None] = [None] * n
    for s in range(n):
        for (i, _o, _w, d) in fst.arcs[s]:
            c = classof(i)
            if state_in[d] is None:
                state_in[d] = c
            else:
                assert state_in[d] == c, "preceding-class invariant violated"
    for s in range(n):
        ts = state_in[s]
        if ts is None or ts == 0:
            continue
        log_fwd = trans_model.non_self_loop_log_prob(ts)
        scale_cost = -log_fwd * self_loop_scale
        fst.arcs[s] = [(i, o, w + scale_cost, d) for (i, o, w, d) in fst.arcs[s]]
        if s in fst.finals:
            fst.finals[s] += scale_cost
        sl_tid = trans_model.self_loop_of(ts)
        if sl_tid != 0:
            cost = -float(trans_model.log_probs[sl_tid]) * self_loop_scale
            fst.add_arc(s, sl_tid, EPS, cost, s)
    return fst
