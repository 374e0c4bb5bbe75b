"""Context dependency: (phone window, pdf-class) -> pdf-id.

(ref: tree/context-dep.h:58 ContextDependency, itf/context-dep-itf.h:34.)
Monophone for the flat-start stage; the tree-based implementation (EventMap)
plugs into the same interface when tied triphones arrive.

The port's copy of kaldi_tpu/tree/context_dep.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations


class ContextDependency:
    """Interface: context_width, central_position, compute(window, pdf_class)."""

    context_width: int = 1
    central_position: int = 0

    def compute(self, phone_window, pdf_class: int) -> int:
        raise NotImplementedError

    @property
    def num_pdfs(self) -> int:
        raise NotImplementedError


class MonophoneContextDependency(ContextDependency):
    """pdf = offset(phone) + pdf_class; contiguous pdf-ids per phone.

    (ref: tree/context-dep.cc MonophoneContextDependency — same mapping the
    flat-start gmm-init-mono uses.)
    """

    def __init__(self, phones, phone2num_pdf_classes):
        self.context_width = 1
        self.central_position = 0
        self._offsets = {}
        total = 0
        for p in sorted(phones):
            self._offsets[p] = total
            total += phone2num_pdf_classes[p]
        self._num_pdfs = total

    def compute(self, phone_window, pdf_class: int) -> int:
        (phone,) = phone_window
        return self._offsets[phone] + pdf_class

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs

    @staticmethod
    def from_topo(topo) -> "MonophoneContextDependency":
        return MonophoneContextDependency(
            topo.phones, {p: topo.num_pdf_classes(p) for p in topo.phones}
        )


class TreeContextDependency(ContextDependency):
    """Decision-tree-based context dependency (tied triphones).

    (ref: tree/context-dep.h:58 ContextDependency over an EventMap.)
    """

    def __init__(self, N: int, P: int, event_map, num_pdfs: int):
        self.context_width = N
        self.central_position = P
        self.event_map = event_map
        self._num_pdfs = num_pdfs

    def compute(self, phone_window, pdf_class: int) -> int:
        from kaldi_tpu_torch.tree.event_map import KPDF_CLASS
        ev = {KPDF_CLASS: pdf_class}
        for pos, p in enumerate(phone_window):
            ev[pos] = int(p)
        ans = self.event_map.map(ev)
        if ans is None:
            raise ValueError(f"tree cannot map window={phone_window} "
                             f"pdf_class={pdf_class}")
        return ans

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs
