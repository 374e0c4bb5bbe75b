"""Build a production-scale triphone HCLG through the port's graph stack.

The port's copy of stage 1 of scripts/mkgraph_scale.py (`build`):
synthetic lexicon + trigram ARPA -> `prepare_lang` -> G -> a synthetic
tied-triphone tree (`tree/synth.py`, 39 phones plus SIL, 6 x 7 context
cells per phone and class) -> the transition model
-> `make_hclg_flat` -> `pack_graph_flat`. It draws from one
`np.random.default_rng(0)` in the same order as the original, so the
same arguments give the same packed arrays; it returns them instead of
writing a file. Host code: the device reads the result through
`CsrBeamDecoder`.

Usage: python -m kaldi_tpu_torch.scripts.mkgraph_scale [vocab] [bigrams]
[trigrams] [--mono] prints the build's stats as JSON.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def build(vocab: int = 60000, n_bigrams: int = 2_000_000,
          n_trigrams: int = 1_000_000, context: str = "tri"):
    """-> (PackedGraph, num_pdfs, stats dict)."""
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.fst.mkgraph_flat import (make_hclg_flat,
                                                  pack_graph_flat)
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.lm.arpa import arpa_to_g
    from kaldi_tpu_torch.lm.synth import synth_lexicon_text, \
        synth_trigram_arpa
    from kaldi_tpu_torch.steps.deltas import transition_model_from_tree
    from kaldi_tpu_torch.tree.context_dep import MonophoneContextDependency
    from kaldi_tpu_torch.tree.synth import synth_triphone_tree

    rng = np.random.default_rng(0)
    stats = {"vocab": vocab, "context": context}
    t_all = time.time()
    text, words = synth_lexicon_text(vocab, n_phones=39, rng=rng)
    lm = synth_trigram_arpa(words, n_bigrams, n_trigrams, rng=rng)
    stats["ngrams"] = [len(d) for d in lm.ngrams]
    lex = Lexicon.parse(text)
    lang = prepare_lang(lex, ["SIL"], "SIL", num_sil_states=3)
    if context == "tri":
        # ~5k-leaf tied-triphone tree (40 phones x 3 classes x 6x7
        # context cells, silence context-independent)
        ctx = synth_triphone_tree(lang.topo,
                                  sil_phones=[lang.phones["SIL"]],
                                  n_left_groups=6, n_right_groups=7,
                                  rng=rng)
        tm = transition_model_from_tree(lang, ctx)
    else:
        ctx = MonophoneContextDependency.from_topo(lang.topo)
        tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    stats["num_pdfs"] = int(tm.num_pdfs)
    stats["num_tids"] = int(tm.num_transition_ids)
    t0 = time.time()
    g = arpa_to_g(lm, lang.words)
    stats["g_states"], stats["g_arcs"] = g.num_states, g.num_arcs
    stats["arpa_to_g_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    hclg, st = make_hclg_flat(lang, g, tm, ctx, self_loop_scale=0.1)
    stats.update(st)
    stats["mkgraph_s"] = round(time.time() - t0, 1)
    packed = pack_graph_flat(hclg, tm.id2pdf_array)
    stats["total_build_s"] = round(time.time() - t_all, 1)
    stats["states"] = int(packed.num_states)
    stats["arcs"] = int(len(packed.ilabel))
    return packed, int(tm.num_pdfs), stats


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sizes = [int(a) for a in args] + [60000, 2_000_000, 1_000_000][len(args):]
    _p, _n, st = build(*sizes[:3],
                       context="mono" if "--mono" in sys.argv else "tri")
    print(json.dumps(st))
