"""Long-tail CLI subcommands of the port (counterpart of
kaldi_tpu/cli_tail.py): lattice set operations and pronunciation
alignment (host code over text lattices, phone sequences and
transcripts, writing JAX's bytes), nnet1 LSTM-stream and
sequence-discriminative training, nnet3 egs diagnostics and KL-HMM
conversion. The commands in DEVICE_COMMANDS run a network on `--device`
(default: cuda) and raise without a card. Registered into the main
parser by kaldi_tpu_torch.cli.main via register(sub).

(ref: latbin/*.cc, bin/{phones-to-prons,prons-to-wordali}.cc,
 nnetbin/*.cc, nnet3bin/*.cc — cited per command.)
"""

from __future__ import annotations

import io
import pickle
import sys

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device

# the subcommands of this module that run a network on `--device`
DEVICE_COMMANDS = (
    "nnet-train-lstm-streams", "nnet-train-blstm-streams",
    "nnet-train-mmi-sequential", "nnet-train-mpe-sequential",
    "nnet3-compute-from-egs", "nnet3-show-progress")


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


# ----------------------------------------------------------- nnet1 tools

def _save_lstm(path, model, params):
    """JAX's lstm1 file: the config, widths and params pickled under the
    JAX package's class names, at the highest protocol, as JAX does."""
    from kaldi_tpu_torch.io.model_io import JaxNamePickler
    from kaldi_tpu_torch.params import params_to_jax
    buf = io.BytesIO()
    JaxNamePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(
        (model.cfg, model.num_pdfs, model.num_layers, model.bidirectional,
         params_to_jax(params)))
    with open(path, "wb") as f:
        np.savez(f, __kind__=np.frombuffer(b"lstm1", np.uint8),
                 __host__=np.frombuffer(buf.getvalue(), np.uint8))


def _load_lstm(path, device):
    """-> (LstmProjected on `device`, its params) from either package's
    lstm1 file."""
    from kaldi_tpu_torch.io.model_io import _loads
    from kaldi_tpu_torch.nnet1.lstm import LstmProjected
    from kaldi_tpu_torch.params import lstm_params_from_jax
    z = np.load(path)
    assert z["__kind__"].tobytes() == b"lstm1", "not an lstm1 file"
    cfg, num_pdfs, num_layers, bidir, tree = _loads(z["__host__"].tobytes())
    model = LstmProjected(cfg, num_pdfs, num_layers=num_layers,
                          bidirectional=bidir, device=device)
    return model, {k: v.to(model.device)
                   for k, v in lstm_params_from_jax(tree).items()}


def cmd_nnet_train_lstm_streams(args, bidirectional=False):
    """Multi-stream truncated-BPTT LSTM training on the device
    (ref: nnetbin/nnet-train-lstm-streams.cc /
    nnet-train-blstm-streams.cc). nnet_in 'init' creates a fresh model
    from --cell-dim/--proj-dim/--num-layers and the data dims, its
    weights from a torch.Generator seeded with --seed (not JAX's key)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.nnet1.lstm import LstmConfig, LstmProjected
    from kaldi_tpu_torch.nnet1.train import StreamTrainOpts, train_lstm_streams
    dev = resolve_device(args.device)
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    utts = []
    num_pdfs = 0
    for utt, ali in open_rspecifier(args.targets_rspecifier):
        if utt not in feats:
            continue
        n = min(len(ali), feats[utt].shape[0])
        t = np.asarray(ali[:n], np.int64)
        utts.append((feats[utt][:n].astype(np.float32), t))
        num_pdfs = max(num_pdfs, int(t.max()) + 1)
    if not utts:
        raise SystemExit("nnet-train-lstm-streams: no utterances")
    if args.nnet_in == "init":
        cfg = LstmConfig(input_dim=utts[0][0].shape[1],
                         cell_dim=args.cell_dim, proj_dim=args.proj_dim)
        model = LstmProjected(cfg, num_pdfs, num_layers=args.num_layers,
                              bidirectional=bidirectional, device=dev)
        params = model.init(torch.Generator().manual_seed(args.seed))
    else:
        model, params = _load_lstm(args.nnet_in, dev)
    params, hist = train_lstm_streams(model, params, utts, StreamTrainOpts(
        num_streams=args.num_streams, bptt_chunk=args.bptt_chunk,
        learning_rate=args.learn_rate, num_epochs=args.num_epochs))
    _save_lstm(args.nnet_out, model, params)
    name = "nnet-train-blstm-streams" if bidirectional else \
        "nnet-train-lstm-streams"
    print(f"{name}: {len(utts)} utts, loss "
          + " -> ".join(f"{h:.3f}" for h in hist), file=sys.stderr)


def cmd_nnet_train_blstm_streams(args):
    """(ref: nnetbin/nnet-train-blstm-streams.cc)"""
    cmd_nnet_train_lstm_streams(args, bidirectional=True)


def _nnet1_sequential(args, criterion: str):
    """nnet1 MMI/MPE sequence-discriminative SGD from lattices
    (ref: nnetbin/nnet-train-mmi-sequential.cc,
    nnet-train-mpe-sequential.cc): per-utterance signed posteriors from
    lattice forward-backward on the host, one gradient step per utterance
    on the device."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.posteriors import (
        lattice_forward_backward_mmi, lattice_forward_backward_mpe_variants,
        rescore_lattice)
    from kaldi_tpu_torch.nnet import optim
    from kaldi_tpu_torch.nnet.train import _grad_step
    from kaldi_tpu_torch.nnet1.nnet import load_nnet1, save_nnet1
    dev = resolve_device(args.device)
    net, params = load_nnet1(args.nnet_in, device=dev)
    tm = load_gmm_system(args.model, device="cpu").trans_model
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    ali = {k: np.asarray(v, np.int64)
           for (k, v) in open_rspecifier(args.ali_rspecifier)}
    tx = optim.sgd(args.learn_rate)
    opt_state = tx.init(params)

    def loss_fn(p, x, post_mat):
        logp = net.apply(p, x)         # [T, P] log-probs
        loss = -torch.sum(post_mat * logp) / max(post_mat.shape[0], 1)
        return loss, loss

    n, tot_objf, tot_frames = 0, 0.0, 0.0
    for key, lat in read_lattice_ark(args.denlat_ark):
        if key not in feats or key not in ali:
            continue
        x = torch.as_tensor(np.asarray(feats[key], np.float32), device=dev)
        with torch.no_grad():
            logp = net.apply(params, x).cpu().numpy()
        # nnet outputs as pseudo-loglikes rescoring the den lattice
        lat = rescore_lattice(lat, logp.astype(np.float64), tm,
                              acoustic_scale=args.acoustic_scale)
        T, P = logp.shape
        post_mat = np.zeros((T, P), np.float32)
        if criterion == "mmi":
            post, objf = lattice_forward_backward_mmi(
                lat, ali[key], tm, drop_frames=args.drop_frames)
        else:
            post, objf = lattice_forward_backward_mpe_variants(
                lat, ali[key], tm, criterion="mpfe")
        for t, frame in enumerate(post):
            for pdf, w in frame:
                if t < T:
                    post_mat[t, pdf] += w
        neg = torch.as_tensor(-post_mat, device=dev)
        params, opt_state, _loss, _aux = _grad_step(
            lambda p: loss_fn(p, x, neg), tx, params, opt_state)
        tot_objf += objf
        tot_frames += T
        n += 1
    save_nnet1(args.nnet_out, net, params)
    print(f"nnet-train-{criterion}-sequential: {n} utts, objf/frame "
          f"{tot_objf / max(tot_frames, 1):.4f}", file=sys.stderr)


def cmd_nnet_train_mmi_sequential(args):
    """(ref: nnetbin/nnet-train-mmi-sequential.cc)"""
    _nnet1_sequential(args, "mmi")


def cmd_nnet_train_mpe_sequential(args):
    """(ref: nnetbin/nnet-train-mpe-sequential.cc)"""
    _nnet1_sequential(args, "mpe")


def cmd_nnet_kl_hmm_mat_to_component(args):
    """KL-HMM stats matrix -> scoring 'component' file, the KlHmm pickled
    under the JAX package's class name (ref:
    nnetbin/nnet-kl-hmm-mat-to-component.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.io.model_io import JaxNamePickler
    from kaldi_tpu_torch.nnet1.kl_hmm import KlHmm
    mat = np.asarray(next(iter(read_ark(args.matrix)))[1], np.float64)
    kl = KlHmm(mat.shape[1], mat.shape[0])
    kl.counts = mat.copy()
    buf = io.BytesIO()
    JaxNamePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(kl)
    with open(args.component_out, "wb") as f:
        np.savez(f, __kind__=np.frombuffer(b"klhmm", np.uint8),
                 __host__=np.frombuffer(buf.getvalue(), np.uint8))
    print(f"nnet-kl-hmm-mat-to-component: {mat.shape[0]} states x "
          f"{mat.shape[1]} dims", file=sys.stderr)


# ----------------------------------------------------------- nnet3 tools

def cmd_nnet3_acc_lda_stats(args):
    """LDA stats from an egs dir (center frames vs targets), for the
    nnet input feature transform (ref: nnet3bin/nnet3-acc-lda-stats.cc)."""
    from kaldi_tpu_torch.cli import _read_egs_dir
    from kaldi_tpu_torch.transform.lda import LdaStats
    egs = _read_egs_dir(args.egs_dir)
    feats = egs["feats"]                     # [N, C, D]
    targets = egs["targets"]                 # [N, chunk]
    N = feats.shape[0]
    chunk = targets.shape[1]
    x = feats.reshape(N, -1)
    y = np.asarray(targets[:, chunk // 2], np.int64)
    stats = LdaStats(int(y.max()) + 1, x.shape[1])
    stats.accumulate(x.astype(np.float64), y)
    with open(args.accs_out, "wb") as f:
        np.savez(f, zero_acc=stats.zero_acc, first_acc=stats.first_acc,
                 total_second=stats.total_second)
    print(f"nnet3-acc-lda-stats: {N} examples", file=sys.stderr)


def cmd_nnet3_compute_from_egs(args):
    """Forward the nnet over egs on the device, write the per-example
    outputs (ref: nnet3bin/nnet3-compute-from-egs.cc)."""
    from kaldi_tpu_torch.cli import _read_egs_dir
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_am_nnet3
    dev = resolve_device(args.device)
    am = load_am_nnet3(args.nnet, device=dev)
    egs = _read_egs_dir(args.egs_dir)
    with torch.inference_mode():
        out_mat = am.model(torch.as_tensor(egs["feats"], device=dev)
                           ).cpu().numpy()
    with open_wspecifier(args.wspecifier) as out:
        for i in range(min(len(out_mat), args.max_examples)):
            out.write(f"eg{i:08d}", out_mat[i].astype(np.float32))
    print(f"nnet3-compute-from-egs: {len(out_mat)} examples",
          file=sys.stderr)


def cmd_nnet3_show_progress(args):
    """Parameter-change norms between two nnet3 models (host, in JAX's
    leaf order), plus the objective on egs if given (on the device)
    (ref: nnet3bin/nnet3-show-progress.cc)."""
    from kaldi_tpu_torch.io.model_io import load_am_nnet3
    from kaldi_tpu_torch.params import nnet3_params_to_jax
    dev = resolve_device(args.device)
    a = load_am_nnet3(args.nnet_old, device=dev)
    b = load_am_nnet3(args.nnet_new, device=dev)
    ta, tb = (nnet3_params_to_jax(m.model.state_dict()) for m in (a, b))
    tot = 0.0
    for comp in sorted(ta):
        for leaf in sorted(ta[comp]):
            tot += float(np.sum((ta[comp][leaf] - tb[comp][leaf]) ** 2))
    print(f"nnet3-show-progress: parameter-change l2 "
          f"{np.sqrt(tot):.6f}")
    if args.egs_dir:
        from kaldi_tpu_torch.cli import _egs_tensors, _read_egs_dir
        from kaldi_tpu_torch.nnet3.training import nnet3_objective
        egs = _egs_tensors(_read_egs_dir(args.egs_dir), dev)
        for name, am in (("old", a), ("new", b)):
            with torch.no_grad():
                loss, acc = nnet3_objective(am.model, am.model.params(),
                                            *egs)
            print(f"nnet3-show-progress: {name} loss {float(loss):.4f} "
                  f"acc {float(acc):.4f}")


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
    for name, fn in (("nnet-train-lstm-streams",
                      cmd_nnet_train_lstm_streams),
                     ("nnet-train-blstm-streams",
                      cmd_nnet_train_blstm_streams)):
        add(name, fn,
            a("rspecifier"), a("targets_rspecifier"),
            a("nnet_in"), a("nnet_out"),
            a("--cell-dim", type=int, default=32),
            a("--proj-dim", type=int, default=16),
            a("--num-layers", type=int, default=1),
            a("--num-streams", type=int, default=4),
            a("--bptt-chunk", type=int, default=20),
            a("--learn-rate", type=float, default=1e-2),
            a("--num-epochs", type=int, default=2),
            a("--seed", type=int, default=0))
    for name, fn in (("nnet-train-mmi-sequential",
                      cmd_nnet_train_mmi_sequential),
                     ("nnet-train-mpe-sequential",
                      cmd_nnet_train_mpe_sequential)):
        add(name, fn,
            a("nnet_in"), a("model"), a("rspecifier"),
            a("denlat_ark"), a("ali_rspecifier"), a("nnet_out"),
            a("--acoustic-scale", type=float, default=0.1),
            a("--learn-rate", type=float, default=1e-4),
            a("--drop-frames", action="store_true"))
    add("nnet-kl-hmm-mat-to-component",
        cmd_nnet_kl_hmm_mat_to_component,
        a("component_out"), a("matrix"))
    add("nnet3-acc-lda-stats", cmd_nnet3_acc_lda_stats,
        a("egs_dir"), a("accs_out"))
    add("nnet3-compute-from-egs", cmd_nnet3_compute_from_egs,
        a("nnet"), a("egs_dir"), a("wspecifier"),
        a("--max-examples", type=int, default=4096))
    add("nnet3-show-progress", cmd_nnet3_show_progress,
        a("nnet_old"), a("nnet_new"),
        a("egs_dir", nargs="?", default=""))
