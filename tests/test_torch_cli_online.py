"""Port parity: the port's online / onlinebin subcommands
(kaldi_tpu_torch/cli_online_extra.py) against kaldi_tpu/cli_online_extra.py
on the same files, on the CPU (`--device cpu`).

The files: tests/test_torch_server.py's yesno monophone and HCLG (trained
by the port, saved by `io/model_io.py`), a seeded TDNN AM saved by JAX's
`save_am_nnet`, yesno waves at 8 kHz in a wav.scp, and their MFCC + delta
features in an ark.
- `online-audio-server-decode-faster` (and its alias
  `online-server-gmm-decode-faster`) over two connections, each client
  (`online-audio-client`, `online-net-client`) against each package's
  server: every client prints the JAX CLI's FINAL lines;
- `online2-wav-nnet2-latgen-threaded`: JAX's transcriptions;
- `online2-wav-nnet2-am-compute`: an ark that both packages read, its rows
  within 2e-4 of the output's largest entry of JAX's (each package
  computes its own online MFCC frames, within rtol 2e-4 of each other,
  tests/test_torch_online_nnet2.py), and equal to the port's `AmNnet`
  on the port's own features within 1e-6;
- `compress-uncompress-speex`: byte-identical wavs and scp;
- `gmm-global-init-from-feats`: the port's UBM (EM on its device) has
  JAX's gaussian count and per-frame log-likelihood on the features
  within 1e-5 relative, its parameters within 1e-3 of their largest
  (f32 posteriors summed in another order, amplified by EM across splits:
  ROADMAP.md §3 traps, "EM drift");
- `gmm-est-fmllr-raw` / `-gpost`: one transform per speaker, its gain per
  frame within 1e-3 relative of JAX's (an Adam run, as
  tests/test_torch_adaptation.py holds it).
"""

import contextlib
import io
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu.io import kaldi_io as jkio
from kaldi_tpu.io import model_io as jmio
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import kaldi_io as tkio
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.wave import write_wave
from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
from kaldi_tpu_torch.online.features import (OnlineFeaturePipeline,
                                             OnlineProcessedFeature)
from kaldi_tpu_torch.ops.features import MfccOpts
from kaldi_tpu_torch.ops.window import FrameOpts
from kaldi_tpu_torch.params import random_tdnn_params
from test_torch_server import gmm  # noqa: F401  (module fixture)

torch.set_num_threads(2)

SR = "8000"


def tmain(argv):
    """The port's CLI on the CPU."""
    return tcli.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def files(gmm, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(21)
    scp = []
    for i, ws in enumerate((["YES", "NO"], ["NO", "YES", "YES"],
                            ["YES", "YES", "NO", "NO"])):
        path = str(d / f"u{i}.wav")
        write_wave(path, cs.yesno_synth(ws, rng), 8000.0)
        scp.append(f"u{i} {path}\n")
    with open(d / "wav.scp", "w") as f:
        f.writelines(scp)
    with open(d / "two.scp", "w") as f:
        f.writelines(scp[:2])
    cfg = dict(feat_dim=39, num_pdfs=gmm["t"].am.num_pdfs, hidden_dim=32,
               nonlinearity="relu", splice_indexes=((-1, 0, 1), (0,)))
    params = random_tdnn_params(TdnnConfig(**cfg), np.random.default_rng(3))
    nnet = str(d / "tdnn.mdl")
    jmio.save_am_nnet(nnet, JAmNnet(
        JTdnn(JTdnnConfig(**cfg)), jax.tree.map(jnp.asarray, params),
        np.random.default_rng(4).dirichlet(np.ones(cfg["num_pdfs"]))))
    return dict(d=d, scp=str(d / "wav.scp"), two=str(d / "two.scp"),
                nnet=nnet, mdl=gmm["mdl"], hclg=gmm["hclg"])


def _out(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _serve(main, argv, port_file):
    t = threading.Thread(target=main, args=(argv,), daemon=True)
    t.start()
    for _ in range(300):
        if os.path.exists(port_file) and open(port_file).read():
            break
        time.sleep(0.05)
    return t, int(open(port_file).read())


SERVERS = {"port": (tmain, "online-audio-server-decode-faster"),
           "jax": (jmain, "online-server-gmm-decode-faster")}
CLIENTS = {"port": (tcli.main, "online-audio-client"),
           "jax": (jmain, "online-net-client")}


def _serve_two(files, server: str, client: str) -> str:
    """One package's server for two connections, one package's client
    streaming the two utterances -> the client's output."""
    pf = str(files["d"] / f"port-{server}-{client}")
    smain, alias = SERVERS[server]
    t, port = _serve(smain, [alias, files["mdl"], files["hclg"],
                             "--port-file", pf, "--num-connections", "2",
                             "--sample-frequency", SR, "--beam", "16",
                             "--max-active", "64"], pf)
    cmain, name = CLIENTS[client]
    out = _out(cmain, [name, "127.0.0.1", str(port), files["two"]])
    t.join(timeout=60)
    assert not t.is_alive()
    return out


@pytest.fixture(scope="module")
def jax_lines(files):
    return _serve_two(files, "jax", "jax")


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_server_and_client_equal_jax(files, jax_lines, server, client):
    out = _serve_two(files, server, client)
    assert out == jax_lines
    lines = out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["u0", "FINAL"],
                                                ["u1", "FINAL"]]
    assert lines[0].split()[2:] == ["YES", "NO"]


def test_threaded_latgen_equals_jax(files):
    d = files["d"]
    common = [files["mdl"], files["nnet"], files["hclg"], files["scp"],
              "--sample-frequency", SR, "--beam", "16", "--max-active", "64",
              "--chunk-secs", "0.3"]
    tmain(["online2-wav-nnet2-latgen-threaded", *common,
           "--transcription-out", str(d / "t.txt")])
    jmain(["online2-wav-nnet2-latgen-threaded", *common,
           "--transcription-out", str(d / "j.txt")])
    t, j = open(d / "t.txt").read(), open(d / "j.txt").read()
    assert t == j and len(t.splitlines()) == 3


@pytest.mark.parametrize("apply_log", [False, True])
def test_am_compute_equals_jax(files, apply_log):
    d = files["d"]
    extra = ["--apply-log"] if apply_log else []
    tmain(["online2-wav-nnet2-am-compute", files["nnet"], files["scp"],
           f"ark:{d / 't.ark'}", "--sample-frequency", SR, *extra])
    jmain(["online2-wav-nnet2-am-compute", files["nnet"], files["scp"],
           f"ark:{d / 'j.ark'}", "--sample-frequency", SR, *extra])
    got = list(tkio.read_ark(str(d / "t.ark")))
    want = list(jkio.read_ark(str(d / "j.ark")))
    assert [k for k, _v in got] == [k for k, _v in want] == \
        ["u0", "u1", "u2"]
    assert [k for k, _v in jkio.read_ark(str(d / "t.ark"))] == \
        ["u0", "u1", "u2"]
    for (_k, a), (_k2, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max()
    # the rows are the port's AmNnet on the port's own online features
    am = tmio.load_am_nnet(files["nnet"], device="cpu")
    from kaldi_tpu_torch.io.wave import read_wave
    for (utt, row), line in zip(got, open(files["scp"])):
        wave, _sr = read_wave(line.split()[1])
        pipe = OnlineProcessedFeature(OnlineFeaturePipeline(
            MfccOpts(frame_opts=FrameOpts(samp_freq=8000.0, dither=0.0)),
            delta_order=2, device="cpu"))
        for lo in range(0, wave.shape[1], 4000):
            pipe.accept_waveform(wave[0, lo:lo + 4000])
        pipe.input_finished()
        x = pipe.get_frames(0, pipe.num_frames_ready())[None]
        ref = (am.log_posteriors(x).numpy() if apply_log
               else am.loglikes_np(x))[0]
        assert np.abs(row - ref).max() <= 1e-6 * np.abs(ref).max(), utt


def test_compress_uncompress_speex_equals_jax(files):
    d = files["d"]
    tcli.main(["compress-uncompress-speex", files["scp"], str(d / "ts"),
           "--chunk-samples", "1001"])
    jmain(["compress-uncompress-speex", files["scp"], str(d / "js"),
           "--chunk-samples", "1001"])
    for u in ("u0", "u1", "u2"):
        assert open(d / "ts" / f"{u}.wav", "rb").read() == \
            open(d / "js" / f"{u}.wav", "rb").read()
    assert open(d / "ts" / "wav.scp").read().replace("/ts/", "/") == \
        open(d / "js" / "wav.scp").read().replace("/js/", "/")


def _feats_ark(files, name):
    from kaldi_tpu_torch.io.wave import read_wave
    items = []
    for line in open(files["scp"]):
        utt, path = line.split()
        items.append((utt, cs.mfcc_deltas(read_wave(path)[0][0], "cpu")))
    path = str(files["d"] / name)
    tkio.write_ark(path, items)
    return path, items


def test_gmm_global_init_from_feats_equals_jax(files):
    ark, items = _feats_ark(files, "feats.ark")
    d = files["d"]
    args = ["--num-gauss", "4", "--num-iters", "3"]
    tmain(["gmm-global-init-from-feats", f"ark:{ark}", str(d / "t.ubm"),
           *args])
    jmain(["gmm-global-init-from-feats", f"ark:{ark}", str(d / "j.ubm"),
           *args])
    t, j = tmio.load_ubm(str(d / "t.ubm")), jmio.load_ubm(str(d / "j.ubm"))
    assert t.num_gauss == j.num_gauss == 4
    x = np.concatenate([f for _u, f in items]).astype(np.float64)
    lt, lj = float(t.loglike(x).mean()), float(j.loglike(x).mean())
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    for k in ("weights", "means", "vars"):
        a, b = getattr(t, k), getattr(j, k)
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), k
    # the port's file is JAX's format
    assert jmio.load_ubm(str(d / "t.ubm")).num_gauss == 4


@pytest.mark.parametrize("name", ["gmm-est-fmllr-raw",
                                  "gmm-est-fmllr-raw-gpost"])
def test_gmm_est_fmllr_raw_equals_jax(files, gmm, name):  # noqa: F811
    """Raw 13-dim MFCC spliced +-1 through a seeded [39, 39] projection
    onto the monophone's features' space; alignments from the monophone's
    equal alignment of its own features. Each speaker's gain per frame
    within 1e-3 relative of JAX's."""
    from kaldi_tpu_torch.io.wave import read_wave
    d = files["d"]
    raw, ali = [], []
    tm = gmm["t"].trans_model
    rng = np.random.RandomState(5)
    for line in open(files["scp"]):
        utt, path = line.split()
        w = read_wave(path)[0][0]
        r = cs.mfcc_raw(w, "cpu")
        raw.append((utt, r))
        pdf_tids = [np.flatnonzero(tm.id2pdf_array == p)[0]
                    for p in range(tm.num_pdfs)]
        ali.append((utt, np.array([pdf_tids[t % tm.num_pdfs]
                                   for t in range(len(r))], np.int32)))
    tkio.write_ark(str(d / "raw.ark"), raw)
    tkio.write_ark(str(d / "ali.ark"), ali)
    T = rng.randn(39, 39) * 0.2 + np.eye(39)
    tkio.write_ark(str(d / "lda.ark"), [("lda", T)])
    with open(d / "utt2spk", "w") as f:
        f.write("u0 s0\nu1 s0\nu2 s1\n")
    common = [files["mdl"], str(d / "lda.ark"), f"ark:{d / 'raw.ark'}",
              f"ark:{d / 'ali.ark'}"]
    opts = ["--splice-left", "1", "--splice-right", "1", "--utt2spk",
            str(d / "utt2spk"), "--min-count", "10"]
    errs = {}
    for side, main in (("t", tmain), ("j", jmain)):
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            main([name, *common, f"ark:{d / (side + 'w.ark')}", *opts])
        errs[side] = {ln.split()[1]: float(ln.split()[-1])
                      for ln in buf.getvalue().splitlines()
                      if "impr/frame" in ln}
    assert list(errs["t"]) == list(errs["j"]) == ["s0", "s1"]
    for spk in errs["t"]:
        assert abs(errs["t"][spk] - errs["j"][spk]) <= \
            1e-3 * abs(errs["j"][spk]), spk
    got = dict(tkio.read_ark(str(d / "tw.ark")))
    assert sorted(got) == ["s0", "s1"]
    assert all(v.shape == (13, 14) and v.dtype == np.float32
               for v in got.values())


def test_cli_device_defaults_to_the_card():
    import argparse
    from kaldi_tpu_torch import cli_online_extra
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd")
    cli_online_extra.register(sub)
    for name in ("online-audio-server-decode-faster",
                 "online-server-gmm-decode-faster",
                 "online2-wav-nnet2-am-compute",
                 "online2-wav-nnet2-latgen-threaded",
                 "gmm-global-init-from-feats", "gmm-est-fmllr-raw",
                 "gmm-est-fmllr-raw-gpost"):
        args = p.parse_args([name] + ["x"] * {
            "gmm-global-init-from-feats": 2,
            "online2-wav-nnet2-am-compute": 3,
            "online2-wav-nnet2-latgen-threaded": 4,
            "gmm-est-fmllr-raw": 5, "gmm-est-fmllr-raw-gpost": 5}.get(
                name, 2))
        assert args.device == "cuda", name
