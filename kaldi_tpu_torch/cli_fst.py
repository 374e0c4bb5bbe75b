"""fstext-tool long-tail CLI subcommands of the port.

Counterpart of kaldi_tpu/cli_fst.py: standalone context-FST
construction, subsequential loops, chain factoring, rho composition,
final-weight propagation through phi, random FSTs (JAX's numpy draws, in
JAX's order), context symbol tables, CD-ilabel deduplication and
per-utterance graph compilation from word FSTs. Host code over the
port's fst/ copies, writing JAX's text FSTs byte for byte. Registered
into the main parser by kaldi_tpu_torch.cli.main via register(sub).

(ref: fstbin/*.cc, bin/make-ilabel-transducer.cc,
 bin/compile-train-graphs-fsts.cc — cited per command.)
"""

from __future__ import annotations

import io as _io
import json
import sys

import numpy as np


def _read_fst_ark(path: str):
    """Yield (key, Fst) from the keyed text-FST archive format
    (blank-line separated blocks, shared with fsts-to-transcripts)."""
    from kaldi_tpu_torch.fst.text_io import read_fst_text
    with open(path) as f:
        blocks = f.read().split("\n\n")
    for block in blocks:
        lines = [ln for ln in block.splitlines() if ln.strip()]
        if not lines:
            continue
        yield lines[0].strip(), read_fst_text(
            _io.StringIO("\n".join(lines[1:])))


def _write_fst_ark(path: str, items):
    from kaldi_tpu_torch.fst.text_io import write_fst_text
    with open(path, "w") as f:
        for key, fst in items:
            f.write(f"{key}\n")
            write_fst_text(f, fst)
            f.write("\n")


def _strip_ark(spec: str) -> str:
    return spec.split(":", 1)[1] if ":" in spec else spec


def cmd_fstaddsubsequentialloop(args):
    """Superfinal state with a subsequential-symbol loop; every final
    state gains a subseq arc into it (ref:
    fstbin/fstaddsubsequentialloop.cc,
    fstext/context-fst-inl.h:401 AddSubsequentialLoop)."""
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    from kaldi_tpu_torch.fst.fst import INF
    f = load_fst(args.fst_in)
    finals = [s for s in range(f.num_states) if f.final(s) < INF]
    superfinal = f.add_state()
    f.add_arc(superfinal, args.subseq_sym, 0, 0.0, superfinal)
    f.set_final(superfinal, 0.0)
    for s in finals:
        f.add_arc(s, args.subseq_sym, 0, f.final(s), superfinal)
    save_fst(args.fst_out, f)
    print(f"fstaddsubsequentialloop: {len(finals)} final states looped",
          file=sys.stderr)


def cmd_fstfactor(args):
    """(ref: fstbin/fstfactor.cc, fstext/factor.h)"""
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    from kaldi_tpu_torch.fst.factor import factor
    f = load_fst(args.fst_in)
    factored, expander = factor(f)
    save_fst(args.fst_out1, factored)
    save_fst(args.fst_out2, expander)
    print(f"fstfactor: {f.num_arcs} arcs -> {factored.num_arcs} "
          f"factored + {expander.num_arcs} expander", file=sys.stderr)


def cmd_fstmakecontextfst(args):
    """Full context transducer C over every phone history
    (ref: fstbin/fstmakecontextfst.cc)."""
    from kaldi_tpu_torch.fst.text_io import save_fst
    from kaldi_tpu_torch.fst.context import make_context_fst
    phones = []
    with open(args.phone_symbols) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2 and int(toks[1]) != 0:
                phones.append(int(toks[1]))
    disambig = set()
    if args.read_disambig_syms:
        with open(args.read_disambig_syms) as f:
            disambig = {int(t) for t in f.read().split()}
    phones = [p for p in phones
              if p not in disambig and p != args.subseq_sym]
    C, ilabel_info = make_context_fst(
        phones, disambig, args.subseq_sym,
        N=args.context_size, P=args.central_position)
    with open(args.ilabels_out, "w") as f:
        json.dump([list(map(int, w)) for w in ilabel_info], f)
    save_fst(args.fst_out, C)
    print(f"fstmakecontextfst: {C.num_states} states, {C.num_arcs} "
          f"arcs, {len(ilabel_info)} ilabels", file=sys.stderr)


def cmd_fstmakecontextsyms(args):
    """Readable symbol table for CLG ilabels: 'a/b/c <id>' lines
    (ref: fstbin/fstmakecontextsyms.cc)."""
    syms = {0: "<eps>"}
    with open(args.phone_symbols) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                syms[int(toks[1])] = toks[0]
    with open(args.ilabels_in) as f:
        ilabel_info = json.load(f)
    for idx, window in enumerate(ilabel_info):
        if not window:
            name = "<eps>"
        elif len(window) == 1 and window[0] < 0:
            name = syms.get(-window[0], f"#?{-window[0]}")
        elif len(window) == 1 and window[0] == 0:
            name = args.initial_disambig
        else:
            name = args.phone_separator.join(
                syms.get(p, str(p)) for p in window)
        print(f"{name} {idx}")
    print(f"fstmakecontextsyms: {len(ilabel_info)} symbols",
          file=sys.stderr)


def cmd_fstpropfinal(args):
    """(ref: fstbin/fstpropfinal.cc)"""
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    from kaldi_tpu_torch.fst.special import prop_final
    f = load_fst(args.fst_in)
    save_fst(args.fst_out, prop_final(f, args.phi_label))
    print("fstpropfinal: done", file=sys.stderr)


def cmd_fstrand(args):
    """Random (acyclic by construction) FST for testing
    (ref: fstbin/fstrand.cc)."""
    from kaldi_tpu_torch.fst.fst import Fst
    from kaldi_tpu_torch.fst.text_io import save_fst
    rng = np.random.RandomState(args.seed)
    f = Fst()
    n = int(rng.randint(2, args.max_states + 1))
    for _ in range(n):
        f.add_state()
    f.start = 0
    for s in range(n - 1):
        for _ in range(rng.randint(1, args.max_arcs_per_state + 1)):
            d = int(rng.randint(s + 1, n))
            il = int(rng.randint(0, args.max_label + 1))
            ol = int(rng.randint(0, args.max_label + 1))
            f.add_arc(s, il, ol, float(rng.uniform(0, 1)), d)
    f.set_final(n - 1, 0.0)
    if args.allow_empty and rng.uniform() < 0.1:
        f = Fst()
    save_fst(args.fst_out, f)
    print(f"fstrand: {f.num_states} states", file=sys.stderr)


def cmd_fstrhocompose(args):
    """(ref: fstbin/fstrhocompose.cc)"""
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    from kaldi_tpu_torch.fst.special import rho_compose
    a = load_fst(args.fst1)
    b = load_fst(args.fst2)
    out = rho_compose(a, b, args.rho_label)
    save_fst(args.fst_out, out)
    print(f"fstrhocompose: {out.num_states} states", file=sys.stderr)


def cmd_make_ilabel_transducer(args):
    """Deduplicate CD ilabels that yield identical pdf sequences under
    the tree: new ilabel info + old->new relabeling transducer
    (ref: bin/make-ilabel-transducer.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.fst.fst import Fst
    from kaldi_tpu_torch.fst.text_io import save_fst
    model = load_gmm_system(args.model, device="cpu")
    ctx = model.ctx_dep
    topo = model.lang.topo
    with open(args.old_ilabels) as f:
        old_info = json.load(f)
    P = getattr(ctx, "central_position", 1)
    sig2new: dict = {}
    new_info: list = []
    mapping = []
    for window in old_info:
        if len(window) <= 1:
            # eps / #-1 / disambig entries map to themselves
            sig = ("special", tuple(window))
        else:
            phone = window[P]
            npdf = topo.num_pdf_classes(phone)
            sig = tuple(ctx.compute(list(window), c) for c in range(npdf))
        new_id = sig2new.get(sig)
        if new_id is None:
            new_id = len(new_info)
            sig2new[sig] = new_id
            new_info.append(list(window))
        mapping.append(new_id)
    with open(args.new_ilabels, "w") as f:
        json.dump([list(map(int, w)) for w in new_info], f)
    m = Fst()
    s0 = m.add_state()
    m.start = s0
    m.set_final(s0, 0.0)
    for old_id, new_id in enumerate(mapping):
        m.add_arc(s0, old_id, new_id, 0.0, s0)
    if args.fst_out:
        save_fst(args.fst_out, m)
    if args.old2new_map:
        with open(args.old2new_map, "w") as f:
            for old_id, new_id in enumerate(mapping):
                f.write(f"{old_id} {new_id}\n")
    print(f"make-ilabel-transducer: {len(old_info)} -> "
          f"{len(new_info)} ilabels", file=sys.stderr)


def cmd_compile_train_graphs_fsts(args):
    """Per-utterance HCLG graphs from word-level grammar FSTs instead
    of linear transcripts (ref: bin/compile-train-graphs-fsts.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    model = load_gmm_system(args.model, device="cpu")
    compiler = TrainingGraphCompiler(
        model.lang, model.trans_model, model.ctx_dep,
        transition_scale=args.transition_scale,
        self_loop_scale=args.self_loop_scale)
    out = []
    for key, g in _read_fst_ark(_strip_ark(args.fsts_rspecifier)):
        hclg = compiler.compile_graph(g)
        out.append((key, hclg))
        print(f"compile-train-graphs-fsts: {key} "
              f"states={hclg.num_states}", file=sys.stderr)
    _write_fst_ark(_strip_ark(args.graphs_wspecifier), out)
    print(f"compile-train-graphs-fsts: {len(out)} graphs",
          file=sys.stderr)


def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    add("fstaddsubsequentialloop", cmd_fstaddsubsequentialloop,
        a("subseq_sym", type=int), a("fst_in"), a("fst_out"))
    add("fstfactor", cmd_fstfactor,
        a("fst_in"), a("fst_out1"), a("fst_out2"))
    add("fstmakecontextfst", cmd_fstmakecontextfst,
        a("phone_symbols"), a("subseq_sym", type=int),
        a("ilabels_out"), a("fst_out"),
        a("--context-size", type=int, default=3),
        a("--central-position", type=int, default=1),
        a("--read-disambig-syms", default=""))
    add("fstmakecontextsyms", cmd_fstmakecontextsyms,
        a("phone_symbols"), a("ilabels_in"),
        a("--phone-separator", default="/"),
        a("--initial-disambig", default="#-1"))
    add("fstpropfinal", cmd_fstpropfinal,
        a("phi_label", type=int), a("fst_in"), a("fst_out"))
    add("fstrand", cmd_fstrand,
        a("fst_out"),
        a("--seed", type=int, default=0),
        a("--max-states", type=int, default=20),
        a("--max-arcs-per-state", type=int, default=3),
        a("--max-label", type=int, default=10),
        a("--allow-empty", action="store_true"))
    add("fstrhocompose", cmd_fstrhocompose,
        a("rho_label", type=int), a("fst1"), a("fst2"), a("fst_out"))
    add("make-ilabel-transducer", cmd_make_ilabel_transducer,
        a("old_ilabels"), a("model"), a("new_ilabels"),
        a("--fst-out", default=""),
        a("--old2new-map", default=""))
    add("compile-train-graphs-fsts", cmd_compile_train_graphs_fsts,
        a("model"), a("fsts_rspecifier"), a("graphs_wspecifier"),
        a("--transition-scale", type=float, default=1.0),
        a("--self-loop-scale", type=float, default=1.0))
