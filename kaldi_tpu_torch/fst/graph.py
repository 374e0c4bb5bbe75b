"""Decoding-graph construction (HCLG) and per-utterance training graphs.

(ref: utils/mkgraph.sh:64-104 — LG = arcsort(minenc(det*_log(L∘G)));
 CLG via context composition; HCLGa = minenc(rmepslocal(rmsym(det*_log(Ha∘CLG))));
 HCLG = add-self-loops(loopscale, reorder=true);
 decoder/training-graph-compiler.h:57-73 TrainingGraphCompiler.)

The port's copy of kaldi_tpu/fst/graph.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses

from kaldi_tpu_torch.fst.fst import Fst, EPS
from kaldi_tpu_torch.fst.compose import compose
from kaldi_tpu_torch.fst.determinize import determinize_star
from kaldi_tpu_torch.fst.minimize import minimize_encoded
from kaldi_tpu_torch.fst.epsilon import remove_eps_local, remove_symbols
from kaldi_tpu_torch.fst.hmm_graph import make_h_transducer, add_self_loops
from kaldi_tpu_torch.fst.lang import Lang
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree.context_dep import ContextDependency


def mono_context(lg: Fst, lang: Lang):
    """Monophone "context expansion": identity relabel + ilabel_info.

    (the N=1,P=0 case of fstcomposecontext; ref: fstext/context-fst.h:491)
    Returns (clg, ilabel_info) where ilabel_info[k] is [] for eps,
    [phone] for a phone, [-sym] for a disambiguation symbol.
    """
    disambig = set(lang.disambig_phone_ids)
    max_sym = len(lang.phones)
    ilabel_info: list[list[int]] = [[]]
    relabel = {EPS: EPS}
    for sym in range(1, max_sym):
        if sym in disambig:
            ilabel_info.append([-sym])
        else:
            ilabel_info.append([sym])
        relabel[sym] = len(ilabel_info) - 1
    clg = lg.copy().relabel(imap=relabel)
    clg.arcsort("ilabel")
    return clg, ilabel_info


@dataclasses.dataclass
class DecodingGraph:
    fst: Fst
    words: "SymbolTable"
    phones: "SymbolTable"


def make_hclg(
    lang: Lang,
    g: Fst,
    trans_model: TransitionModel,
    ctx_dep: ContextDependency,
    transition_scale: float = 1.0,
    self_loop_scale: float = 0.1,
) -> DecodingGraph:
    """Full HCLG build (ref: utils/mkgraph.sh), mono or N-phone context."""
    lg = compose(lang.L_disambig, g)
    lg = determinize_star(lg, use_log=True)
    lg = minimize_encoded(lg)
    if ctx_dep.context_width == 1:
        clg, ilabel_info = mono_context(lg, lang)
    else:
        from kaldi_tpu_torch.fst.context import compose_context
        clg, ilabel_info = compose_context(
            lg, set(lang.disambig_phone_ids),
            N=ctx_dep.context_width, P=ctx_dep.central_position)
    ha, disambig_tids = make_h_transducer(
        ilabel_info, ctx_dep, trans_model, transition_scale)
    hclga = compose(ha, clg)
    hclga = determinize_star(hclga, use_log=True)
    remove_symbols(hclga, disambig_tids)
    remove_eps_local(hclga)
    hclga = minimize_encoded(hclga)
    hclg = add_self_loops(hclga, trans_model, (), self_loop_scale, reorder=True)
    hclg.connect()
    hclg.arcsort("ilabel")
    return DecodingGraph(fst=hclg, words=lang.words, phones=lang.phones)


class TrainingGraphCompiler:
    """Per-utterance (transcript) graphs for alignment.

    (ref: decoder/training-graph-compiler.h:57,73 — the per-utterance
    pipeline L∘G_utt -> det* -> context -> H -> det* -> self-loops.)
    """

    def __init__(
        self,
        lang: Lang,
        trans_model: TransitionModel,
        ctx_dep: ContextDependency,
        transition_scale: float = 1.0,
        self_loop_scale: float = 1.0,
    ):
        self.lang = lang
        self.tm = trans_model
        self.ctx = ctx_dep
        self.tscale = transition_scale
        self.loopscale = self_loop_scale

    def compile(self, word_ids: list[int]) -> Fst:
        return self.compile_graph(Fst.linear_acceptor(word_ids))

    def compile_graph(self, g_utt: Fst) -> Fst:
        """Per-utterance graph from an arbitrary word-level G (not just a
        linear transcript) (ref: bin/compile-train-graphs-fsts.cc)."""
        lg = compose(self.lang.L_disambig, g_utt)
        lg = determinize_star(lg, use_log=False)
        if self.ctx.context_width == 1:
            clg, ilabel_info = mono_context(lg, self.lang)
        else:
            from kaldi_tpu_torch.fst.context import compose_context
            clg, ilabel_info = compose_context(
                lg, set(self.lang.disambig_phone_ids),
                N=self.ctx.context_width, P=self.ctx.central_position)
        ha, disambig_tids = make_h_transducer(
            ilabel_info, self.ctx, self.tm, self.tscale)
        hclg = compose(ha, clg)
        hclg = determinize_star(hclg, use_log=False)
        remove_symbols(hclg, disambig_tids)
        remove_eps_local(hclg)
        hclg = add_self_loops(hclg, self.tm, (), self.loopscale, reorder=True)
        hclg.connect()
        return hclg

    def compile_transcript(self, words: list[str]) -> Fst:
        return self.compile([self.lang.words[w] for w in words])
