"""Context dependency: (phone window, pdf-class) -> pdf-id.

(ref: tree/context-dep.h:58 ContextDependency, itf/context-dep-itf.h:34.)
Monophone for the flat-start stage; the tree-based implementation (EventMap)
plugs into the same interface when tied triphones arrive.

The port's copy of kaldi_tpu/tree/context_dep.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
`TreeContextDependency` (tied triphones) is not ported yet.
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

