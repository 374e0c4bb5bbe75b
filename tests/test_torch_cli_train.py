"""Port parity: the first CLI slice's training, graph and decoding
subcommands (kaldi_tpu_torch/cli.py, cli_nnet.py) against kaldi_tpu's CLI,
on the CPU (`--device cpu`), over files that either package wrote.

- `recipe-yesno-files --device cpu` through the port's own `main`: WER 0
  on the GMM and the streaming-TDNN paths, the artifacts, 24 alignments
  (tests/test_cli_train.py:16-35); its files load in JAX.
- `train-mono` against JAX's on the recipe's features: the same gaussian
  count, the same words, WER 0 (EM drifts apart from last-bit
  differences, ROADMAP.md §3 traps, so whole runs are held by outcome).
- `mkgraph` (and `--flat`) on JAX's model: JAX's graph array for array.
- `decode-faster` (and its aliases) and `gmm-align` (and its alias) on
  JAX-written files equal JAX's output, and JAX's commands on the
  port-written files equal the port's.
- `nnet-am-compute` (plain, `--divide-by-priors`, `--apply-exp`) within
  1e-5 of JAX's (tests/test_torch_am_nnet.py's TOL);
  `decode-faster-mapped` on one loglikes ark prints JAX's words.
- `train-tdnn`: weights start from a torch.Generator, so held to JAX's
  outcome: WER 0 through files, the file loads in both packages with
  loglikes within 1e-5, and identical loglikes after a reload.
- `train-nnet3` (TDNN and LSTM): the saved file reloads to identical
  loglikes, and JAX's loader computes them within 1e-5.
- `online2-wav-nnet2-latgen-faster --fused` equals the generic pipeline on
  a delta-free system (tests/test_cli_train.py:71-98), and JAX's command
  prints the same words on the port's files.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu.io import model_io as jmio
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, read_ark
from test_torch_cli_features import _call

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)        # tests/test_torch_am_nnet.py


def tmain(argv):
    """The port's CLI on the CPU -> (stdout, exit code)."""
    return _call(tcli.main, argv + ["--device", "cpu"])


def jrun(argv):
    return _call(jmain, argv)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The port's file-driven recipe on the CPU, and JAX's monophone
    system trained on its features (train-mono, mkgraph)."""
    root = tmp_path_factory.mktemp("cli_train")
    w = str(root / "w")
    out, code = tmain(["recipe-yesno-files", w])
    P = lambda *n: os.path.join(w, *n)                       # noqa: E731
    J = lambda *n: os.path.join(str(root), *n)              # noqa: E731
    jrun(["train-mono", P("lexicon.txt"), P("train", "text"),
          f"ark:{P('train', 'feats.ark')}", J("jmono.npz")])
    jrun(["mkgraph", J("jmono.npz"), P("lm.arpa"), J("jhclg.npz")])
    return dict(P=P, J=J, out=out, code=code)


def _words(text: str) -> dict:
    return {ln.split()[0]: ln.split()[1:] for ln in text.splitlines()
            if ln.strip()}


def test_recipe_yesno_files_reaches_wer_0_on_both_paths(work):
    P = work["P"]
    assert work["code"] == 0
    wers = [ln for ln in work["out"].splitlines() if ln.startswith("%WER")]
    assert len(wers) == 2 and all(ln.startswith("%WER 0.00 ") for ln in wers)
    for f in ("mono.npz", "hclg.npz", "tdnn.npz", "ali.ark",
              "hyp_gmm.txt", "hyp_tdnn.txt"):
        assert os.path.getsize(P(f)) > 0, f
    alis = list(open_rspecifier(f"ark:{P('ali.ark')}"))
    assert len(alis) == 24
    assert all(len(t) > 0 and (t > 0).all() for _u, t in alis)
    # what the port wrote, JAX reads
    assert jmio.load_gmm_system(P("mono.npz")).am.num_pdfs == \
        tmio.load_gmm_system(P("mono.npz"), device="cpu").am.num_pdfs
    assert jmio.load_hclg(P("hclg.npz")).num_states > 0
    assert jmio.load_am_nnet(P("tdnn.npz")) is not None


def _num_gauss(path):
    z = np.load(path)
    return [z[f"pdf{i}_weights"].shape[0] for i in range(int(z["num_pdfs"]))]


def test_train_mono_matches_jax_by_words_wer_and_gaussians(work, tmp_path):
    P, J = work["P"], work["J"]
    t = str(tmp_path / "tmono.npz")
    assert tmain(["train-mono", P("lexicon.txt"), P("train", "text"),
                  f"ark:{P('train', 'feats.ark')}", t])[1] == 0
    assert sum(_num_gauss(t)) == sum(_num_gauss(J("jmono.npz")))
    assert _call(tcli.main, ["mkgraph", t, P("lm.arpa"),
                             str(tmp_path / "thclg.npz")])[1] == 0
    got, _ = tmain(["decode-faster", t, str(tmp_path / "thclg.npz"),
                    f"ark:{P('test', 'feats.ark')}"])
    want, _ = jrun(["decode-faster", J("jmono.npz"), J("jhclg.npz"),
                    f"ark:{P('test', 'feats.ark')}"])
    assert _words(got) == _words(want)
    assert _words(want) == _words(open(P("test", "text")).read())


@pytest.mark.parametrize("flat", [False, True])
def test_mkgraph_equals_jax(work, tmp_path, flat):
    P, J = work["P"], work["J"]
    extra = ["--flat"] if flat else []
    outs = {}
    for side, main in (("jax", jmain), ("port", tcli.main)):
        outs[side] = str(tmp_path / f"{side}.npz")
        assert _call(main, ["mkgraph", J("jmono.npz"), P("lm.arpa"),
                            outs[side], *extra])[1] == 0
    a, b = np.load(outs["jax"]), np.load(outs["port"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["decode-faster", "gmm-decode-faster",
                                  "gmm-decode-simple"])
def test_decode_faster_both_directions(work, name):
    P, J = work["P"], work["J"]
    feats = f"ark:{P('test', 'feats.ark')}"
    got, _ = tmain([name, J("jmono.npz"), J("jhclg.npz"), feats])
    want, _ = jrun([name, J("jmono.npz"), J("jhclg.npz"), feats])
    assert got == want and len(want.splitlines()) == 8
    want, _ = jrun([name, P("mono.npz"), P("hclg.npz"), feats])
    assert want == open(P("hyp_gmm.txt")).read()


@pytest.mark.parametrize("name", ["gmm-align", "gmm-align-compiled"])
def test_gmm_align_both_directions(work, tmp_path, name):
    P, J = work["P"], work["J"]
    args = [P("train", "text"), f"ark:{P('train', 'feats.ark')}"]
    tmain([name, J("jmono.npz"), *args, f"ark:{tmp_path}/t.ark"])
    jrun([name, J("jmono.npz"), *args, f"ark:{tmp_path}/j.ark"])
    jrun([name, P("mono.npz"), *args, f"ark:{tmp_path}/jp.ark"])
    read = lambda n: open(os.path.join(tmp_path, n), "rb").read()  # noqa
    assert read("t.ark") == read("j.ark")
    assert read("jp.ark") == open(P("ali.ark"), "rb").read()


@pytest.mark.parametrize("extra", [[], ["--divide-by-priors"],
                                   ["--apply-exp"]],
                         ids=["log-posteriors", "loglikes", "posteriors"])
def test_nnet_am_compute_within_bound(work, tmp_path, extra):
    P = work["P"]
    args = [P("tdnn.npz"), f"ark:{P('test', 'feats.ark')}"]
    tmain(["nnet-am-compute", *args, f"ark:{tmp_path}/t.ark", *extra])
    jrun(["nnet-am-compute", *args, f"ark:{tmp_path}/j.ark", *extra])
    got = list(read_ark(str(tmp_path / "t.ark")))
    want = list(read_ark(str(tmp_path / "j.ark")))
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) == 8
    for (_k, g), (_k2, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def test_decode_faster_mapped_prints_jax_words(work, tmp_path):
    P = work["P"]
    ll = f"ark:{tmp_path}/ll.ark"
    jrun(["nnet-am-compute", P("tdnn.npz"), f"ark:{P('test', 'feats.ark')}",
          f"ark:{tmp_path}/ll.ark", "--divide-by-priors"])
    got, code = tmain(["decode-faster-mapped", P("hclg.npz"), ll,
                       "--beam", "12", "--max-active", "128"])
    want, _ = jrun(["decode-faster-mapped", P("hclg.npz"), ll, "--beam",
                    "12", "--max-active", "128"])
    assert code == 0 and got == want and len(want.splitlines()) == 8


def _decode_through_files(main, dev, work, nnet, tmp):
    """nnet-am-compute --divide-by-priors -> decode-faster-mapped ->
    words through one package's CLI."""
    P = work["P"]
    ll = f"ark:{tmp}/ll.ark"
    main(["nnet-am-compute", nnet, f"ark:{P('test', 'feats.ark')}", ll,
          "--divide-by-priors", *dev])
    main(["decode-faster-mapped", P("hclg.npz"), ll, "--transcription-out",
          f"{tmp}/ids.txt", *dev])
    words = tmio.load_gmm_system(P("mono.npz"), device="cpu").lang.words
    return {k: [words.sym(int(i)) for i in v]
            for k, v in _words(open(f"{tmp}/ids.txt").read()).items()}


def test_train_tdnn_matches_jax_outcome(work, tmp_path):
    P = work["P"]
    args = [P("mono.npz"), P("train", "text"),
            f"ark:{P('train', 'feats.ark')}"]
    t, j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert tmain(["train-tdnn", *args, t])[1] == 0
    assert jrun(["train-tdnn", *args, j])[1] == 0
    ref = _words(open(P("test", "text")).read())
    os.makedirs(tmp_path / "td")
    os.makedirs(tmp_path / "jd")
    assert _decode_through_files(tcli.main, ["--device", "cpu"], work, t,
                                 str(tmp_path / "td")) == ref
    assert _decode_through_files(jmain, [], work, j,
                                 str(tmp_path / "jd")) == ref
    x = np.random.RandomState(0).randn(1, 40, 39).astype(np.float32)
    am = tmio.load_am_nnet(t, device="cpu")
    np.testing.assert_allclose(jmio.load_am_nnet(t).loglikes_np(x),
                               am.loglikes_np(x), **TOL)
    tmio.save_am_nnet(str(tmp_path / "t2.npz"), am)
    assert np.array_equal(
        tmio.load_am_nnet(str(tmp_path / "t2.npz"),
                          device="cpu").loglikes_np(x), am.loglikes_np(x))


@pytest.mark.parametrize("net,extra", [
    ("tdnn", ["--num-epochs", "8"]),
    ("lstm", ["--num-epochs", "2", "--cell-dim", "16", "--proj-dim", "8"])])
def test_train_nnet3_round_trip(work, tmp_path, net, extra):
    P = work["P"]
    out = str(tmp_path / "nnet3.npz")
    assert tmain(["train-nnet3", P("mono.npz"), P("train", "text"),
                  f"ark:{P('train', 'feats.ark')}", out, "--net-type", net,
                  *extra])[1] == 0
    am = tmio.load_am_nnet3(out, device="cpu")
    x = np.random.RandomState(0).randn(1, 30, 39).astype(np.float32)
    ll = am.loglikes_np(x)
    assert ll.shape[:2] == (1, 30) and np.isfinite(ll).all()
    out2 = str(tmp_path / "nnet3b.npz")
    tmio.save_am_nnet3(out2, am)
    assert np.array_equal(
        tmio.load_am_nnet3(out2, device="cpu").loglikes_np(x), ll)
    np.testing.assert_allclose(jmio.load_am_nnet3(out).loglikes_np(x), ll,
                               **TOL)


def test_online2_fused_equals_generic_and_jax(work, tmp_path):
    P = work["P"]
    D = lambda n: str(tmp_path / n)                         # noqa: E731
    tmain(["train-mono", P("lexicon.txt"), P("train", "text"),
           f"ark:{P('train', 'mfcc.ark')}", D("mono0.npz"),
           "--num-iters", "12", "--totgauss", "60", "--max-iter-inc", "8"])
    _call(tcli.main, ["mkgraph", D("mono0.npz"), P("lm.arpa"),
                      D("hclg0.npz")])
    tmain(["train-tdnn", D("mono0.npz"), P("train", "text"),
           f"ark:{P('train', 'mfcc.ark')}", D("tdnn0.npz"),
           "--num-epochs", "30", "--initial-lr", "0.1",
           "--final-lr", "0.01", "--momentum", "0.9"])
    common = [D("mono0.npz"), D("tdnn0.npz"), D("hclg0.npz"),
              P("test", "wav.scp"), "--sample-frequency", "8000",
              "--delta-order", "0"]
    generic, _ = tmain(["online2-wav-nnet2-latgen-faster", *common])
    fused, _ = tmain(["online2-wav-nnet2-latgen-faster", *common,
                      "--fused"])
    assert sorted(generic.splitlines()) == sorted(fused.splitlines())
    assert len(generic.splitlines()) == 8
    assert jrun(["online2-wav-nnet2-latgen-faster", *common])[0] == generic


def test_chip_smoke_cli_phase_runs_cpu_against_itself(tmp_path):
    """chip_smoke.py's phase 35 helpers with the CPU on both sides: every
    case of CLI_CASES runs and compares, the recipe reaches WER 0 on both
    paths, --fused equals the generic pipeline, train-nnet3 round-trips."""
    import chip_smoke as cs
    res = cs.cli_card_vs_cpu(str(tmp_path / "cases"), card="cpu")
    names = {n for n, _a, _k, _o in cs.CLI_CASES}
    assert set(res) == names and len(names) == len(cs.CLI_CASES)
    tr = cs.cli_train_card_vs_cpu(str(tmp_path / "train"), card="cpu")
    assert tr["stages"]["train-mono"] > 0
    ported = names | set(tr["seconds"])
    assert {"recipe-yesno-files", "train-nnet3", "cuda-compiled",
            "cuda-gpu-available", "decode-faster-mapped",
            "nnet-am-compute"} <= ported
