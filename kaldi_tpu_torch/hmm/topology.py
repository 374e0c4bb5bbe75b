"""HMM topology: per-phone prototype HMMs.

(ref: hmm/hmm-topology.h:94 HmmTopology — text format with <Topology>,
<TopologyEntry>, <ForPhones>, <State> blocks.) We keep the same conceptual
model: each phone maps to a topology entry; an entry is a list of states;
each state has an optional pdf_class and a list of (next_state, init_prob)
transitions; the final state is non-emitting with no transitions.

The port's copy of kaldi_tpu/hmm/topology.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HmmState:
    pdf_class: int | None  # None for non-emitting
    transitions: list[tuple[int, float]]  # (dest_state, initial prob)


class HmmTopology:
    def __init__(self, phone2entry: dict[int, list[HmmState]]):
        self.phone2entry = dict(phone2entry)
        for phone, entry in self.phone2entry.items():
            if not entry:
                raise ValueError(f"empty topology entry for phone {phone}")
            if entry[-1].transitions or entry[-1].pdf_class is not None:
                raise ValueError(
                    f"last state of phone {phone} must be non-emitting final")

    @property
    def phones(self) -> list[int]:
        return sorted(self.phone2entry)

    def entry(self, phone: int) -> list[HmmState]:
        return self.phone2entry[phone]

    def num_pdf_classes(self, phone: int) -> int:
        pcs = [s.pdf_class for s in self.entry(phone) if s.pdf_class is not None]
        return max(pcs) + 1 if pcs else 0

    @staticmethod
    def three_state(phones, num_states: int = 3) -> "HmmTopology":
        """Standard left-to-right Bakis topology (the reference's default
        `topo` prepared by utils/gen_topo / prepare_lang.sh)."""
        entry = []
        for s in range(num_states):
            entry.append(
                HmmState(pdf_class=s,
                         transitions=[(s, 0.5), (s + 1, 0.5)])
            )
        entry.append(HmmState(pdf_class=None, transitions=[]))
        return HmmTopology({p: [HmmState(st.pdf_class, list(st.transitions))
                                for st in entry] for p in phones})

    @staticmethod
    def five_state_silence(sil_phones, other_phones, num_sil_states: int = 5):
        """Kaldi-style topology: 3-state for speech, 5-state ergodic-ish for
        silence (as produced by utils/prepare_lang.sh's gen_topo)."""
        topo = HmmTopology.three_state(other_phones).phone2entry
        n = num_sil_states
        for p in sil_phones:
            entry = []
            if n == 5:
                # state 0 -> {0,1,2,3}; states 1..3 -> {1,2,3,4-ish}; state 4 -> {4, final}
                entry.append(HmmState(0, [(0, 0.25), (1, 0.25), (2, 0.25), (3, 0.25)]))
                entry.append(HmmState(1, [(1, 0.25), (2, 0.25), (3, 0.25), (4, 0.25)]))
                entry.append(HmmState(2, [(1, 0.25), (2, 0.25), (3, 0.25), (4, 0.25)]))
                entry.append(HmmState(3, [(1, 0.25), (2, 0.25), (3, 0.25), (4, 0.25)]))
                entry.append(HmmState(4, [(4, 0.75), (5, 0.25)]))
                entry.append(HmmState(None, []))
            else:
                for s in range(n):
                    entry.append(HmmState(s, [(s, 0.5), (s + 1, 0.5)]))
                entry.append(HmmState(None, []))
            topo[p] = entry
        return HmmTopology(topo)

    def write(self, f):
        """Kaldi-compatible text format writer."""
        f.write("<Topology>\n")
        # group phones by identical entry
        groups: dict[str, list[int]] = {}
        for phone in self.phones:
            key = repr([(s.pdf_class, s.transitions) for s in self.entry(phone)])
            groups.setdefault(key, []).append(phone)
        for key, phones in groups.items():
            f.write("<TopologyEntry>\n<ForPhones>\n")
            f.write(" ".join(map(str, phones)) + "\n")
            f.write("</ForPhones>\n")
            entry = self.entry(phones[0])
            for i, st in enumerate(entry):
                if st.pdf_class is None:
                    f.write(f"<State> {i} </State>\n")
                else:
                    parts = [f"<State> {i} <PdfClass> {st.pdf_class}"]
                    for dst, p in st.transitions:
                        parts.append(f"<Transition> {dst} {p}")
                    f.write(" ".join(parts) + " </State>\n")
            f.write("</TopologyEntry>\n")
        f.write("</Topology>\n")

    @staticmethod
    def read(f) -> "HmmTopology":
        toks = f.read().split()
        pos = 0

        def expect(t):
            nonlocal pos
            assert toks[pos] == t, f"expected {t}, got {toks[pos]}"
            pos += 1

        expect("<Topology>")
        phone2entry: dict[int, list[HmmState]] = {}
        while toks[pos] == "<TopologyEntry>":
            pos += 1
            expect("<ForPhones>")
            phones = []
            while toks[pos] != "</ForPhones>":
                phones.append(int(toks[pos]))
                pos += 1
            pos += 1
            entry: list[HmmState] = []
            while toks[pos] == "<State>":
                pos += 2  # <State> idx
                pdf_class = None
                transitions = []
                while toks[pos] != "</State>":
                    if toks[pos] == "<PdfClass>":
                        pdf_class = int(toks[pos + 1])
                        pos += 2
                    elif toks[pos] == "<Transition>":
                        transitions.append((int(toks[pos + 1]), float(toks[pos + 2])))
                        pos += 3
                    else:
                        raise ValueError(f"bad token {toks[pos]}")
                pos += 1
                entry.append(HmmState(pdf_class, transitions))
            expect("</TopologyEntry>")
            for p in phones:
                phone2entry[p] = [HmmState(s.pdf_class, list(s.transitions))
                                  for s in entry]
        expect("</Topology>")
        return HmmTopology(phone2entry)
