"""Long-tail CLI subcommands of the port (counterpart of
kaldi_tpu/cli_tail.py, holding the ported ones): lattice set operations
and pronunciation alignment. All are host code over text lattices,
phone sequences and transcripts, writing JAX's bytes. Registered into
the main parser by kaldi_tpu_torch.cli.main via register(sub).

(ref: latbin/*.cc, bin/{phones-to-prons,prons-to-wordali}.cc — cited per
 command.)
"""

from __future__ import annotations

import sys

import numpy as np


# --------------------------------------------------------- lattice tools

def cmd_lattice_copy_backoff(args):
    """Copy lattices from the second table when present, falling back to
    the first (sequential over the first)
    (ref: latbin/lattice-copy-backoff.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    good = dict(read_lattice_ark(args.lat2))
    out = {}
    n_backed = 0
    for key, lat in read_lattice_ark(args.lat1):
        if key in good:
            out[key] = good[key]
        else:
            out[key] = lat
            n_backed += 1
    write_lattice_ark(args.lat_out, out)
    print(f"lattice-copy-backoff: {len(out)} lattices, {n_backed} "
          f"backed off", file=sys.stderr)


def cmd_lattice_difference(args):
    """Remove paths from lattice 1 whose word sequences appear in
    lattice 2 — the MCE denominator construction
    (ref: latbin/lattice-difference.cc). Exact difference via a product
    with the forbidden-sequence trie."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.lattice import Lattice
    second = dict(read_lattice_ark(args.lat2))
    out = {}
    n_empty = 0
    for key, lat in read_lattice_ark(args.lat1):
        if key not in second:
            out[key] = lat
            continue
        forbidden = {tuple(words) for (words, _t, _c)
                     in second[key].paths(max_paths=1000)}
        # trie over forbidden sequences; -1 = dead state (kept paths)
        trie: list[dict] = [{}]
        accept = set()
        for seq in forbidden:
            node = 0
            for w in seq:
                nxt = trie[node].get(w)
                if nxt is None:
                    nxt = len(trie)
                    trie[node][w] = nxt
                    trie.append({})
                node = nxt
            accept.add(node)
        new = Lattice()
        state_map: dict = {}

        def get(s, node):
            k = (s, node)
            if k not in state_map:
                state_map[k] = new.add_state()
            return state_map[k]

        new.start = get(lat.start, 0)
        stack = [(lat.start, 0)]
        seen = {(lat.start, 0)}
        while stack:
            s, node = stack.pop()
            cur = state_map[(s, node)]
            if s in lat.finals and node not in accept:
                g, ac = lat.finals[s]
                new.set_final(cur, g, ac)
            for a in lat.arcs[s]:
                if a.olabel == 0 or node < 0:
                    nxt_node = node
                else:
                    nxt_node = trie[node].get(a.olabel, -1)
                k = (a.nextstate, nxt_node)
                if k not in seen:
                    seen.add(k)
                    stack.append(k)
                new.add_arc(cur, a.ilabel, a.olabel, a.graph_cost,
                            a.acoustic_cost, get(*k))
        new.connect()
        if new.num_states == 0:
            n_empty += 1
        else:
            out[key] = new
    write_lattice_ark(args.lat_out, out)
    print(f"lattice-difference: {len(out)} written, {n_empty} became "
          f"empty", file=sys.stderr)


def cmd_lattice_expand_ngram(args):
    """Expand states so each carries a unique (n-1)-word history
    (ref: latbin/lattice-expand-ngram.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.lattice import Lattice
    n = args.n
    out = {}
    for key, lat in read_lattice_ark(args.lat_in):
        new = Lattice()
        state_map: dict = {}

        def get(s, hist):
            k = (s, hist)
            if k not in state_map:
                state_map[k] = new.add_state()
            return state_map[k]

        start_key = (lat.start, ())
        new.start = get(*start_key)
        stack = [start_key]
        seen = {start_key}
        while stack:
            s, hist = stack.pop()
            cur = state_map[(s, hist)]
            if s in lat.finals:
                g, ac = lat.finals[s]
                new.set_final(cur, g, ac)
            for a in lat.arcs[s]:
                h2 = hist if a.olabel == 0 else \
                    tuple((list(hist) + [a.olabel])[-(n - 1):])
                k = (a.nextstate, h2)
                if k not in seen:
                    seen.add(k)
                    stack.append(k)
                new.add_arc(cur, a.ilabel, a.olabel, a.graph_cost,
                            a.acoustic_cost, get(*k))
        out[key] = new
    write_lattice_ark(args.lat_out, out)
    print(f"lattice-expand-ngram: {len(out)} lattices", file=sys.stderr)


# ---------------------------------------------------- pronunciation tools

def cmd_nbest_to_prons(args):
    """Word-aligned linear lattices -> 'utt start len word phones...'
    lines (ref: latbin/nbest-to-prons.cc; input from
    lattice-align-words)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    tm = load_gmm_system(args.model, device="cpu").trans_model
    with open(args.out, "w") as out:
        n = 0
        for key, lat in read_lattice_ark(args.lattice_ark):
            t = 0
            s = lat.start
            while True:
                if s in lat.finals or not lat.arcs[s]:
                    break
                a = lat.arcs[s][0]
                tids = a.tids if a.tids else ()
                phones = _tids_to_phones(tm, tids)
                out.write(f"{key} {t} {len(tids)} {a.olabel} "
                          + " ".join(str(p) for p in phones) + "\n")
                t += len(tids)
                s = a.nextstate
            n += 1
    print(f"nbest-to-prons: {n} utts", file=sys.stderr)


def _tids_to_phones(tm, tids):
    from kaldi_tpu_torch.lat.align import ali_to_phones
    if not tids:
        return []
    segs = ali_to_phones(tm, np.asarray(tids, np.int64))
    return [ph for (ph, _s, _d) in segs]


def cmd_phones_to_prons(args):
    """Segment phone alignments into per-word pronunciations by
    matching lexicon entries against the word sequence
    (ref: bin/phones-to-prons.cc — the reference composes with L_align;
    the lexicon-DP here recovers the same segmentation, optional
    silence between words included). Output lines:
    'utt word p1 p2 .. ; word p1 ..' (word 0 = silence chunks)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.cli import _read_text_file
    model = load_gmm_system(args.model, device="cpu")
    lang = model.lang
    # lexicon text: 'word [prob] phone phone ...'
    prons: dict = {}
    with open(args.lexicon) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2 or toks[0] not in lang.words:
                continue
            wid = lang.words[toks[0]]
            rest = toks[1:]
            try:
                float(rest[0])
                if rest[0] not in lang.phones:
                    rest = rest[1:]
            except ValueError:
                pass
            pron = tuple(lang.phones[p] for p in rest
                         if p in lang.phones)
            if pron:
                prons.setdefault(wid, []).append(pron)
    sil = {lang.phones[p] for p in lang.silence_phones
           if p in lang.phones}
    text = _read_text_file(args.words)
    n = 0
    with open(args.prons_out, "w") as out:
        for utt, phone_seq in open_rspecifier(args.phones_rspecifier):
            if utt not in text:
                continue
            phones = [int(p) for p in np.asarray(phone_seq).reshape(-1)]
            words = [lang.words[w] for w in text[utt]]
            segs = _match_prons(phones, words, prons, sil)
            if segs is None:
                print(f"phones-to-prons: failed for {utt}",
                      file=sys.stderr)
                continue
            out.write(utt + " " + " ; ".join(
                f"{w} " + " ".join(str(p) for p in ps)
                for (w, ps) in segs) + "\n")
            n += 1
    print(f"phones-to-prons: {n} utts", file=sys.stderr)


def _match_prons(phones, words, prons, sil):
    """DP segmentation of `phones` into words' pronunciations with
    optional silence chunks between; -> [(word, phones)] or None."""
    from functools import lru_cache
    P, W = len(phones), len(words)

    def sil_run(i):
        j = i
        while j < P and phones[j] in sil:
            j += 1
        return j

    @lru_cache(maxsize=None)
    def rec(i, w):
        # optional silence chunk
        for use_sil in (False, True):
            start = i
            segs0 = []
            if use_sil:
                j = sil_run(i)
                if j == i:
                    continue
                segs0 = [(0, tuple(phones[i:j]))]
                start = j
            if w == W:
                if start == P:
                    return tuple(segs0)
                continue
            for pron in prons.get(words[w], []):
                L = len(pron)
                if tuple(phones[start:start + L]) == pron:
                    rest = rec(start + L, w + 1)
                    if rest is not None:
                        return tuple(segs0) + ((words[w], pron),) + rest
        return None

    res = rec(0, 0)
    return None if res is None else [(w, list(p)) for (w, p) in res]


def cmd_prons_to_wordali(args):
    """Pronunciations + per-phone lengths -> word alignment pairs
    'word nframes ; ...' (ref: bin/prons-to-wordali.cc)."""
    lengths = {}
    path = args.lengths_rspecifier.split(":", 1)[-1]
    with open(path) as f:
        for line in f:
            toks = line.split(None, 1)
            if len(toks) < 2:
                continue
            segs = []
            for part in toks[1].split(";"):
                pp = part.split()
                if len(pp) == 2:
                    segs.append((int(pp[0]), int(pp[1])))
            lengths[toks[0]] = segs
    n = 0
    with open(args.wordali_out, "w") as out:
        for line in open(args.prons_rspecifier.split(":", 1)[-1]):
            toks = line.split(None, 1)
            if len(toks) < 2 or toks[0] not in lengths:
                continue
            utt = toks[0]
            segs = lengths[utt]
            k = 0
            pieces = []
            ok = True
            for chunk in toks[1].split(";"):
                pp = chunk.split()
                if not pp:
                    continue
                word = int(pp[0])
                n_ph = len(pp) - 1
                dur = 0
                for _ in range(n_ph):
                    if k >= len(segs):
                        ok = False
                        break
                    dur += segs[k][1]
                    k += 1
                pieces.append(f"{word} {dur}")
            if ok:
                out.write(utt + " " + " ; ".join(pieces) + "\n")
                n += 1
    print(f"prons-to-wordali: {n} utts", file=sys.stderr)


# ------------------------------------------------------------ registration

def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    add("lattice-copy-backoff", cmd_lattice_copy_backoff,
        a("lat1"), a("lat2"), a("lat_out"))
    add("lattice-difference", cmd_lattice_difference,
        a("lat1"), a("lat2"), a("lat_out"))
    add("lattice-expand-ngram", cmd_lattice_expand_ngram,
        a("lat_in"), a("lat_out"), a("--n", type=int, default=3))
    add("nbest-to-prons", cmd_nbest_to_prons,
        a("model"), a("lattice_ark"), a("out"))
    add("phones-to-prons", cmd_phones_to_prons,
        a("model"), a("lexicon"), a("phones_rspecifier"), a("words"),
        a("prons_out"))
    add("prons-to-wordali", cmd_prons_to_wordali,
        a("prons_rspecifier"), a("lengths_rspecifier"), a("wordali_out"))
