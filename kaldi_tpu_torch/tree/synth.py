"""Synthetic tied-triphone decision tree for scale benchmarks.

Real tree building (tree/build_tree.py) needs acoustic stats from an
aligned corpus; the scale benchmarks have a synthetic lexicon/LM with no
audio, but still need a REALISTIC triphone tree — one whose structure
matches trained production trees (ref: a trained tree is, per center
phone and pdf-class, a partition of the left/right context phones into
clustered groups; e.g. the sre10 recipe's 5297-senone system): silence
is context-independent, every (left, center, right, pdf_class) window
maps to a leaf, and leaf counts are in the thousands.

The synthetic tree partitions left and right context phones into GL/GR
groups with per-(center, class) random shuffles (distinct centers split
their contexts differently, like real trees), expressed with the same
TableEventMap machinery the trained path uses — so ContextDependency,
TransitionModel, and the graph pipeline exercise identical code.

The port's copy of kaldi_tpu/tree/synth.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.tree.context_dep import TreeContextDependency
from kaldi_tpu_torch.tree.event_map import (ConstantEventMap, TableEventMap,
                                      KPDF_CLASS)


def synth_triphone_tree(topo, sil_phones=(), n_left_groups: int = 6,
                        n_right_groups: int = 7, rng=None,
                        central_position: int = 1):
    """-> TreeContextDependency (N=3).

    Leaves: context-independent phones get one leaf per pdf-class;
    context-dependent phones get n_left_groups * n_right_groups leaves
    per pdf-class. Phone 0 (the epsilon context at utterance edges)
    belongs to group 0 on both sides.
    """
    rng = rng or np.random.default_rng(0)
    phones = list(topo.phones)
    sil = set(sil_phones)
    next_leaf = [0]

    def alloc():
        leaf = next_leaf[0]
        next_leaf[0] += 1
        return leaf

    def context_split(center, pdf_class):
        # per-(center, class) random grouping of context phones
        left_of = {0: 0}
        right_of = {0: 0}
        lp = rng.permutation(len(phones))
        rp = rng.permutation(len(phones))
        for i, p in enumerate(phones):
            left_of[p] = int(lp[i]) % n_left_groups
            right_of[p] = int(rp[i]) % n_right_groups
        cell = [[alloc() for _ in range(n_right_groups)]
                for _ in range(n_left_groups)]
        right_maps = [TableEventMap(
            central_position + 1,
            {p: ConstantEventMap(cell[g][right_of[p]]) for p in [0] + phones})
            for g in range(n_left_groups)]
        return TableEventMap(
            central_position - 1,
            {p: right_maps[left_of[p]] for p in [0] + phones})

    center_table = {}
    for p in phones:
        ncls = topo.num_pdf_classes(p)
        if p in sil:
            cls_table = {c: ConstantEventMap(alloc()) for c in range(ncls)}
        else:
            cls_table = {c: context_split(p, c) for c in range(ncls)}
        center_table[p] = TableEventMap(KPDF_CLASS, cls_table)
    tree = TableEventMap(central_position, center_table)
    return TreeContextDependency(3, central_position, tree, next_leaf[0])
