"""Transition model: transition-id ⇄ (phone, hmm-state, pdf) mapping + probs.

(ref: hmm/transition-model.h:121 TransitionModel.) Identical information
content to the reference: a "transition state" is a (phone, hmm_state, pdf)
triple; each of its outgoing topology transitions gets a global 1-based
transition-id. Alignments are sequences of transition-ids. Probabilities are
stored as log-probs in a flat numpy array so per-frame transition scoring in
the aligner/decoder is a single gather.

The port's copy of kaldi_tpu/hmm/transition_model.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.hmm.topology import HmmTopology


class TransitionModel:
    def __init__(self, topo: HmmTopology, phone_state_to_pdf):
        """phone_state_to_pdf: callable (phone, pdf_class) -> pdf_id or an
        iterable of pdf_ids.

        Monophone systems return a single pdf; tied-triphone systems return
        every pdf the tree can assign to that (phone, pdf_class) — the
        reference computes the same set via ContextDependency::GetPdfInfo
        (ref: hmm/transition-model.cc ComputeTuples).
        """
        self.topo = topo
        # tuples[ts] = (phone, hmm_state, pdf); transition-state = 1-based
        tuples = []
        for phone in topo.phones:
            entry = topo.entry(phone)
            for hmm_state, st in enumerate(entry):
                if st.pdf_class is None:
                    continue
                pdfs = phone_state_to_pdf(phone, st.pdf_class)
                if isinstance(pdfs, (int, np.integer)):
                    pdfs = [pdfs]
                for pdf in sorted(set(int(p) for p in pdfs)):
                    tuples.append((phone, hmm_state, pdf))
        tuples.sort()
        self.tuples = tuples
        self._tuple_index = {t: i for i, t in enumerate(tuples)}

        # per transition-state: offset into the flat transition-id space
        self._state2id = np.zeros(len(tuples) + 2, dtype=np.int32)
        self._id2state = [0]  # index 0 unused (transition-ids are 1-based)
        self._id2pdf = [-1]
        cur_id = 1
        for ts, (phone, hmm_state, pdf) in enumerate(tuples, start=1):
            self._state2id[ts] = cur_id
            n_trans = len(topo.entry(phone)[hmm_state].transitions)
            for _ in range(n_trans):
                self._id2state.append(ts)
                self._id2pdf.append(pdf)
            cur_id += n_trans
        self._state2id[len(tuples) + 1] = cur_id
        self.num_transition_ids = cur_id - 1
        self.id2state = np.asarray(self._id2state, dtype=np.int32)
        self.id2pdf_array = np.asarray(self._id2pdf, dtype=np.int32)

        # initial log probs from topology
        probs = np.zeros(cur_id, dtype=np.float32)
        for ts, (phone, hmm_state, pdf) in enumerate(tuples, start=1):
            trans = topo.entry(phone)[hmm_state].transitions
            off = self._state2id[ts]
            for i, (_dst, p) in enumerate(trans):
                probs[off + i] = p
        with np.errstate(divide="ignore"):
            self.log_probs = np.log(probs)  # index 0 = -inf, unused
        self.num_pdfs = int(self.id2pdf_array.max()) + 1 if cur_id > 1 else 0

    # --- mappings (ref: transition-model.h:240-280) ---

    def tuple_to_transition_state(self, phone, hmm_state, pdf) -> int:
        return self._tuple_index[(phone, hmm_state, pdf)] + 1

    def pair_to_transition_id(self, trans_state: int, trans_index: int) -> int:
        return int(self._state2id[trans_state]) + trans_index

    def transition_id_to_transition_state(self, tid: int) -> int:
        return int(self.id2state[tid])

    def transition_id_to_transition_index(self, tid: int) -> int:
        ts = self.id2state[tid]
        return int(tid - self._state2id[ts])

    def transition_id_to_pdf(self, tid: int) -> int:
        return int(self.id2pdf_array[tid])

    def transition_id_to_phone(self, tid: int) -> int:
        return self.tuples[self.id2state[tid] - 1][0]

    def transition_id_to_hmm_state(self, tid: int) -> int:
        return self.tuples[self.id2state[tid] - 1][1]

    def is_self_loop(self, tid: int) -> bool:
        ts = self.id2state[tid]
        phone, hmm_state, _ = self.tuples[ts - 1]
        idx = tid - self._state2id[ts]
        trans = self.topo.entry(phone)[hmm_state].transitions
        return trans[idx][0] == hmm_state

    def is_final(self, tid: int) -> bool:
        ts = self.id2state[tid]
        phone, hmm_state, _ = self.tuples[ts - 1]
        idx = tid - self._state2id[ts]
        dst = self.topo.entry(phone)[hmm_state].transitions[idx][0]
        return self.topo.entry(phone)[dst].pdf_class is None

    def self_loop_of(self, trans_state: int) -> int:
        """transition-id of the self-loop of this transition state, or 0."""
        phone, hmm_state, _ = self.tuples[trans_state - 1]
        trans = self.topo.entry(phone)[hmm_state].transitions
        for i, (dst, _p) in enumerate(trans):
            if dst == hmm_state:
                return self.pair_to_transition_id(trans_state, i)
        return 0

    def transition_ids_of_state(self, trans_state: int):
        lo = int(self._state2id[trans_state])
        hi = int(self._state2id[trans_state + 1])
        return list(range(lo, hi))

    def non_self_loop_log_prob(self, trans_state: int) -> float:
        """log(1 - p_selfloop) = log of total non-self-loop mass
        (ref: transition-model.cc:328 GetNonSelfLoopLogProb)."""
        import math
        sl = self.self_loop_of(trans_state)
        total = 0.0
        for tid in self.transition_ids_of_state(trans_state):
            if tid != sl:
                total += math.exp(float(self.log_probs[tid]))
        return math.log(max(total, 1e-20))

    def transition_log_prob_ignoring_self_loops(self, tid: int) -> float:
        """(ref: transition-model.cc:333) renormalized excluding self-loop."""
        ts = int(self.id2state[tid])
        return float(self.log_probs[tid]) - self.non_self_loop_log_prob(ts)

    # --- estimation (ref: hmm/transition-model.cc MleUpdate) ---

    def mle_update(self, counts: np.ndarray, floor: float = 0.01,
                   min_count: float = 5.0):
        """counts: [num_transition_ids+1] occupation counts by transition-id."""
        new_log = self.log_probs.copy()
        objf_impr = 0.0
        tot_count = 0.0
        for ts in range(1, len(self.tuples) + 1):
            lo = int(self._state2id[ts])
            hi = int(self._state2id[ts + 1])
            c = counts[lo:hi].astype(np.float64)
            tot = c.sum()
            tot_count += tot
            if tot < min_count:
                continue
            p = c / tot
            p = np.maximum(p, floor)
            p /= p.sum()
            old_logp = self.log_probs[lo:hi]
            new_logp = np.log(p).astype(np.float32)
            objf_impr += float(np.sum(c * (new_logp - old_logp)))
            new_log[lo:hi] = new_logp
        self.log_probs = new_log
        return objf_impr, tot_count

    # --- serialization ---

    def state_dict(self):
        return {
            "tuples": np.asarray(self.tuples, dtype=np.int32),
            "log_probs": self.log_probs,
        }

    def load_log_probs(self, log_probs: np.ndarray):
        assert log_probs.shape == self.log_probs.shape
        self.log_probs = log_probs.astype(np.float32)
