"""EventMap: pure-functional decision-tree mapping event sets -> pdf-ids.

(ref: tree/event-map.h:86-269 — ConstantEventMap / TableEventMap /
 SplitEventMap over events = sorted (key, value) pair lists; key -1
 (kPdfClass) is the HMM-state position, keys 0..N-1 are context positions.)

The port's copy of kaldi_tpu/tree/event_map.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

KPDF_CLASS = -1


class EventMap:
    def map(self, event: dict) -> int | None:
        raise NotImplementedError

    def multi_map(self, event: dict) -> set:
        """All answers reachable when some keys are unspecified."""
        raise NotImplementedError

    def max_answer(self) -> int:
        raise NotImplementedError


class ConstantEventMap(EventMap):
    def __init__(self, answer: int):
        self.answer = answer

    def map(self, event):
        return self.answer

    def multi_map(self, event):
        return {self.answer}

    def max_answer(self):
        return self.answer

    def __repr__(self):
        return f"CE({self.answer})"


class TableEventMap(EventMap):
    def __init__(self, key: int, table: dict[int, EventMap]):
        self.key = key
        self.table = table

    def map(self, event):
        v = event.get(self.key)
        if v is None or v not in self.table:
            return None
        return self.table[v].map(event)

    def multi_map(self, event):
        if self.key in event:
            sub = self.table.get(event[self.key])
            return sub.multi_map(event) if sub else set()
        out = set()
        for sub in self.table.values():
            out |= sub.multi_map(event)
        return out

    def max_answer(self):
        return max((m.max_answer() for m in self.table.values()), default=-1)

    def __repr__(self):
        return f"TE(key={self.key}, n={len(self.table)})"


class SplitEventMap(EventMap):
    def __init__(self, key: int, yes_set: frozenset, yes: EventMap, no: EventMap):
        self.key = key
        self.yes_set = frozenset(yes_set)
        self.yes = yes
        self.no = no

    def map(self, event):
        v = event.get(self.key)
        if v is None:
            return None
        return (self.yes if v in self.yes_set else self.no).map(event)

    def multi_map(self, event):
        if self.key in event:
            branch = self.yes if event[self.key] in self.yes_set else self.no
            return branch.multi_map(event)
        return self.yes.multi_map(event) | self.no.multi_map(event)

    def max_answer(self):
        return max(self.yes.max_answer(), self.no.max_answer())

    def __repr__(self):
        return f"SE(key={self.key}, |yes|={len(self.yes_set)})"


def map_leaves(em: EventMap, fn) -> EventMap:
    """Rebuild with leaf answers transformed by fn (renumbering etc.)."""
    if isinstance(em, ConstantEventMap):
        return ConstantEventMap(fn(em.answer))
    if isinstance(em, TableEventMap):
        return TableEventMap(em.key, {v: map_leaves(m, fn)
                                      for v, m in em.table.items()})
    if isinstance(em, SplitEventMap):
        return SplitEventMap(em.key, em.yes_set,
                             map_leaves(em.yes, fn), map_leaves(em.no, fn))
    raise TypeError(type(em))


def collect_leaves(em: EventMap) -> list[int]:
    if isinstance(em, ConstantEventMap):
        return [em.answer]
    if isinstance(em, TableEventMap):
        out = []
        for m in em.table.values():
            out.extend(collect_leaves(m))
        return out
    if isinstance(em, SplitEventMap):
        return collect_leaves(em.yes) + collect_leaves(em.no)
    raise TypeError(type(em))
