"""Port parity: the first CLI slice's feature, CMVN, pitch and wave
subcommands (kaldi_tpu_torch/cli.py, cli_misc.py) against kaldi_tpu's CLI
on the same seeded files, on the CPU (`--device cpu`).

Each case runs both packages' `main` on the same inputs into two output
directories and compares what they write and print (paths of the port's
directory read as JAX's):
- host commands (CMVN statistics, VAD, pitch post-processing and
  interpolation, waves, segments, two-channel and online CMVN) write
  byte-equal files and print equal lines;
- device commands are held to the bound of the module's parity test:
  MFCC, fbank, spectrogram and PLP to rtol 2e-4 / atol 2e-3
  (tests/test_torch_features.py; the spectrogram's bins plus the FFT's
  rounding-error bound, chip_smoke.fft_feature_bound, which outgrows it
  in a bin far below its frame's power); deltas, splicing, shifted deltas and
  per-utterance CMVN to 1e-6 (tests/test_torch_online_features.py's
  EXACT_TOL: the same f32 taps), sliding CMVN to 2e-5 (its sliding-CMVN
  cases: window sums by cumulative sums in f32); the pitch features to 1e-6 of each
  column's scale (tests/test_torch_pitch_signal.py: the same path on every
  frame, the NCCF within 1e-7 of its scale, then f32); `transform-feats`
  (f64 products on both sides, then f32) to 1e-6; `wav-reverberate` to
  one int16 step (1e-6 of max |y| in f32, tests/test_torch_pitch_signal
  .py, then rounded to int16 by the same writer).
test_cli.py's pipeline and `--config` cases, test_cli_extras.py's,
test_cli_leftovers2.py's pitch and wave cases and
test_feat_lattice_extras_cli.py's feature cases, on the port.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
from kaldi_tpu_torch.io.wave import read_wave, write_wave

torch.set_num_threads(2)

FEAT_TOL = dict(rtol=2e-4, atol=2e-3)       # tests/test_torch_features.py
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)      # test_torch_online_features.py
SLIDING_TOL = dict(rtol=2e-5, atol=2e-5)    # its sliding-CMVN cases
SR = "8000"


# ----------------------------------------------------------- the harness

def _call(main, argv, err=None):
    """-> (stdout, exit code) of one package's main; its stderr into
    `err` when given."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(err or io.StringIO()):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (
                0 if e.code is None else 1)
    return buf.getvalue(), code


def run_both(tmp, argv_fn, device: bool):
    """Run argv_fn(out_dir) through JAX's main and the port's (with
    `--device cpu` where the command builds a device object) ->
    {"jax": (dir, stdout + stderr, code), "port": (...)}, the port's
    output with its directory read as JAX's."""
    out = {}
    for side, main in (("jax", jmain), ("port", tcli.main)):
        d = os.path.join(tmp, side)
        os.makedirs(d, exist_ok=True)
        argv = argv_fn(d) + (["--device", "cpu"]
                             if device and side == "port" else [])
        err = io.StringIO()
        text, code = _call(main, argv, err)
        text += err.getvalue()
        out[side] = (d, text.replace(d, os.path.join(tmp, "jax")), code)
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _ds, fs in os.walk(d) for f in fs)


def same_bytes(res):
    """Every file the two runs wrote is byte-equal (a path of the port's
    directory inside a text file read as JAX's), stdout, stderr and exit
    code equal."""
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert _files(jd) == _files(td) and (_files(jd) or jout)
    assert (jout, jcode) == (tout, tcode)
    for f in _files(jd):
        a = open(os.path.join(jd, f), "rb").read()
        b = open(os.path.join(td, f), "rb").read()
        assert a == b.replace(td.encode(), jd.encode()), f


def same_arks(res, name, close):
    """The ark `name` has JAX's keys, shapes and dtypes, each matrix
    within `close(got, want)`."""
    (jd, _jo, jcode), (td, _to, tcode) = res["jax"], res["port"]
    assert jcode == tcode == 0
    want = list(read_ark(os.path.join(jd, name)))
    got = list(read_ark(os.path.join(td, name)))
    assert [k for k, _ in got] == [k for k, _ in want] and want
    for (k, g), (_k2, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        close(g, w, k)


def tol(**kw):
    return lambda g, w, k=None: np.testing.assert_allclose(g, w, **kw)


def fft_close(P, kind):
    """FEAT_TOL plus the FFT's rounding-error bound of each element
    (chip_smoke.fft_feature_bound: a bin far below its frame's power)."""
    bounds = cs.cli_fft_bounds(P, kind)

    def close(g, w, k):
        assert (np.abs(g.astype(np.float64) - w)
                <= FEAT_TOL["atol"] + FEAT_TOL["rtol"] * np.abs(w)
                + bounds[k]).all()
    return close


def col_scale_close(rel):
    """|got - want| <= rel * max |want| per column."""
    def close(g, w, k=None):
        scale = np.maximum(np.abs(w).max(axis=0), 1e-30)
        assert (np.abs(g.astype(np.float64) - w) <= rel * scale).all()
    return close


# ------------------------------------------------------------- the files

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded inputs: three yesno waves at 8 kHz (one stereo) in a
    wav.scp, an RIR, a segments file, MFCC-like features, a (nccf, pitch)
    ark, CMVN statistics, VAD decisions, a transform, utt2spk/spk2utt
    and reco2file_and_channel maps."""
    d = tmp_path_factory.mktemp("in")
    P = lambda *n: str(d.joinpath(*n))                       # noqa: E731
    rng = np.random.RandomState(17)
    scp = []
    for i, ws in enumerate((["YES", "NO"], ["NO", "YES", "YES"],
                            ["YES", "NO", "NO"])):
        w = cs.yesno_synth(ws, rng)
        if i == 2:
            w = np.stack([w, 0.5 * w[::-1]])
        write_wave(P(f"u{i}.wav"), w, 8000.0)
        scp.append(f"u{i} {P(f'u{i}.wav')}\n")
    with open(P("wav.scp"), "w") as f:
        f.writelines(scp)
    rir = np.exp(-np.arange(400) / 60.0) * rng.randn(400)
    rir[0] = 1.0
    write_wave(P("rir.wav"), (rir * 3000).astype(np.float32), 8000.0)
    with open(P("segments"), "w") as f:
        f.write("s0 u0 0.10 0.50\ns1 u1 0.25 0.90\ns2 u2 0.00 0.35\n")
    feats = {f"u{i}": (rng.randn(T, 13) * 3 + rng.randn(13) * 5)
             .astype(np.float32) for i, T in enumerate((57, 83, 40))}
    write_ark(P("feats.ark"), feats)
    pitch = {}
    for k, T in (("u0", 60), ("u1", 45)):
        nccf = rng.uniform(-0.2, 1.0, T)
        f0 = 120 + 30 * np.sin(np.arange(T) / 7.0) + rng.randn(T)
        pitch[k] = np.stack([nccf, f0], 1).astype(np.float32)
    write_ark(P("pitch.ark"), pitch)
    write_ark(P("vad.ark"), {k: (v[:, 0] > np.median(v[:, 0]))
                             .astype(np.float32) for k, v in feats.items()})
    W = rng.randn(10, 14)
    write_ark(P("affine.ark"), {"t": W.astype(np.float32)})
    write_ark(P("linear.ark"), {"t": W[:, :13].astype(np.float32)})
    with open(P("utt2spk"), "w") as f:
        f.write("u0 A\nu1 B\nu2 A\n")
    with open(P("spk2utt"), "w") as f:
        f.write("A u0 u2\nB u1\n")
    with open(P("reco2file_and_channel"), "w") as f:
        f.write("u0 call1 A\nu1 call1 B\nu2 call2 A\n")
    stats = {}
    for k, v in feats.items():
        x = v.astype(np.float64)
        st = np.zeros((2, 14))
        st[0, :13], st[0, 13] = x.sum(0), len(x)
        st[1, :13] = (x * x).sum(0)
        stats[k] = st
    write_ark(P("cmvn.ark"), stats)
    with open(P("mfcc.conf"), "w") as f:
        f.write("--sample-frequency=8000\n--dither=0\nnum-ceps 11\n"
                "# a comment\n")
    return P


# ------------------------------------------------------- device commands

def _wav_feats(kind, *extra):
    return (f"compute-{kind}-feats",
            lambda P, o: ["compute-" + kind + "-feats", P("wav.scp"),
                          f"ark,scp:{o}/f.ark,{o}/f.scp",
                          "--sample-frequency", SR, "--dither", "0",
                          *extra], "f.ark")


DEVICE_CASES = {
    "mfcc": (*_wav_feats("mfcc"), tol(**FEAT_TOL)),
    "mfcc-ceps-bins": (*_wav_feats("mfcc", "--num-ceps", "10",
                                   "--num-mel-bins", "20"),
                       tol(**FEAT_TOL)),
    "mfcc-frame-opts": ("compute-mfcc-feats", lambda P, o: [
        "compute-mfcc-feats", P("wav.scp"), f"ark:{o}/f.ark",
        "--sample-frequency", SR, "--dither", "0", "--channel", "0",
        "--frame-length", "20", "--frame-shift", "8"], "f.ark",
        tol(**FEAT_TOL)),
    "fbank": (*_wav_feats("fbank", "--num-mel-bins", "15"),
              tol(**FEAT_TOL)),
    "spectrogram": (*_wav_feats("spectrogram"), "spec"),
    "plp": (*_wav_feats("plp"), tol(**FEAT_TOL)),
    "pitch": (*_wav_feats("pitch"), col_scale_close(1e-6)),
    "kaldi-pitch-alias": ("compute-kaldi-pitch-feats", lambda P, o: [
        "compute-kaldi-pitch-feats", P("wav.scp"), f"ark:{o}/f.ark",
        "--sample-frequency", SR], "f.ark", col_scale_close(1e-6)),
    "compute-and-process-pitch": (
        "compute-and-process-kaldi-pitch-feats", lambda P, o: [
            "compute-and-process-kaldi-pitch-feats", P("wav.scp"),
            f"ark:{o}/f.ark", "--sample-frequency", SR,
            "--frame-shift", "12"], "f.ark", col_scale_close(1e-6)),
    "mfcc-config": ("compute-mfcc-feats", lambda P, o: [
        "compute-mfcc-feats", f"--config={P('mfcc.conf')}", P("wav.scp"),
        f"ark:{o}/f.ark"], "f.ark", tol(**FEAT_TOL)),
    "add-deltas": ("add-deltas", lambda P, o: [
        "add-deltas", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark"], "f.ark",
        tol(**EXACT_TOL)),
    "add-deltas-order-window": ("add-deltas", lambda P, o: [
        "add-deltas", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark",
        "--delta-order", "3", "--delta-window", "1"], "f.ark",
        tol(**EXACT_TOL)),
    "add-deltas-sdc": ("add-deltas-sdc", lambda P, o: [
        "add-deltas-sdc", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark",
        "--d", "2", "--p", "2", "--k", "5"], "f.ark", tol(**EXACT_TOL)),
    "splice-feats": ("splice-feats", lambda P, o: [
        "splice-feats", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark",
        "--left-context", "3", "--right-context", "2"], "f.ark",
        tol(**EXACT_TOL)),
    "apply-cmvn": ("apply-cmvn", lambda P, o: [
        "apply-cmvn", f"ark:{P('cmvn.ark')}", f"ark:{P('feats.ark')}",
        f"ark:{o}/f.ark"], "f.ark", tol(**EXACT_TOL)),
    "apply-cmvn-norm-vars-utt2spk": ("apply-cmvn", lambda P, o: [
        "compute-cmvn-stats", f"ark:{P('feats.ark')}", f"ark:{o}/s.ark",
        "--spk2utt", P("spk2utt")], None, None),
    "apply-cmvn-sliding": ("apply-cmvn-sliding", lambda P, o: [
        "apply-cmvn-sliding", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark",
        "--cmn-window", "30", "--min-window", "10", "--norm-vars"],
        "f.ark", tol(**SLIDING_TOL)),
    "apply-cmvn-sliding-center": ("apply-cmvn-sliding", lambda P, o: [
        "apply-cmvn-sliding", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark",
        "--cmn-window", "25", "--center"], "f.ark", tol(**SLIDING_TOL)),
    "transform-feats-affine": ("transform-feats", lambda P, o: [
        "transform-feats", P("affine.ark"), f"ark:{P('feats.ark')}",
        f"ark:{o}/f.ark"], "f.ark", tol(**EXACT_TOL)),
    "transform-feats-linear": ("transform-feats", lambda P, o: [
        "transform-feats", P("linear.ark"), f"ark:{P('feats.ark')}",
        f"ark:{o}/f.ark"], "f.ark", tol(**EXACT_TOL)),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_command_equals_jax(case, data, tmp_path):
    _name, argv, ark, close = DEVICE_CASES[case]
    if ark is None:       # per-speaker statistics, then --norm-vars
        stats = run_both(str(tmp_path / "s"), lambda o: argv(data, o),
                         False)
        same_bytes(stats)
        s_ark = os.path.join(stats["jax"][0], "s.ark")
        res = run_both(str(tmp_path), lambda o: [
            "apply-cmvn", f"ark:{s_ark}", f"ark:{data('feats.ark')}",
            f"ark:{o}/f.ark", "--utt2spk", data("utt2spk"), "--norm-vars"],
            True)
        same_arks(res, "f.ark", tol(**EXACT_TOL))
        return
    if isinstance(close, str):
        close = fft_close(data, close)
    res = run_both(str(tmp_path), lambda o: argv(data, o), True)
    same_arks(res, ark, close)


def test_features_scp_and_compression_equal_jax(data, tmp_path):
    """The scp beside a feature ark names the same offsets, and
    `--compress` of equal features is byte-equal (the fbank of the JAX
    run, copied through both packages' copy-feats)."""
    res = run_both(str(tmp_path / "f"), lambda o: [
        "compute-fbank-feats", data("wav.scp"), f"ark,scp:{o}/f.ark,{o}/f.scp",
        "--sample-frequency", SR, "--dither", "0"], True)
    j, t = (open(os.path.join(res[s][0], "f.scp")).read()
            for s in ("jax", "port"))
    assert t.replace(res["port"][0], res["jax"][0]) == j
    src = os.path.join(res["jax"][0], "f.ark")
    for extra in ([], ["--compress"]):
        same_bytes(run_both(str(tmp_path / f"c{len(extra)}"), lambda o: [
            "copy-feats", f"ark:{src}", f"ark:{o}/c.ark", *extra], False))


def test_wav_reverberate_within_one_step(data, tmp_path):
    res = run_both(str(tmp_path), lambda o: [
        "wav-reverberate", data("u0.wav"), data("rir.wav"), f"{o}/r.wav"],
        True)
    (jw, jsr), (tw, tsr) = (read_wave(os.path.join(res[s][0], "r.wav"))
                            for s in ("jax", "port"))
    assert jsr == tsr and jw.shape == tw.shape
    assert np.abs(jw - tw).max() <= 1.0


def test_pipeline_feeds_compute_wer(data, tmp_path):
    """test_cli.py's pipeline through the port: MFCC -> deltas -> CMVN
    statistics -> apply-cmvn, each stage fed JAX's output of the stage
    before and within its bound of JAX's (the statistics byte-equal), then
    compute-wer's report and exit code equal."""
    steps = [
        (["compute-mfcc-feats", data("wav.scp"), "ark:{o}/m.ark",
          "--sample-frequency", SR, "--dither", "0"], "m.ark",
         tol(**FEAT_TOL)),
        (["add-deltas", "ark:{i}/m.ark", "ark:{o}/d.ark"], "d.ark",
         tol(**EXACT_TOL)),
        (["compute-cmvn-stats", "ark:{i}/d.ark", "ark:{o}/s.ark"], "s.ark",
         None),
        (["apply-cmvn", "ark:{i}/s.ark", "ark:{i}/d.ark", "ark:{o}/n.ark",
          "--norm-vars"], "n.ark", tol(**EXACT_TOL)),
    ]
    jdir = str(tmp_path / "jax")
    for k, (argv, ark, close) in enumerate(steps):
        res = run_both(str(tmp_path), lambda o: [
            x.format(o=o, i=jdir) for x in argv],
            argv[0] in tcli.DEVICE_COMMANDS)
        if close is None:
            (jd, _, _), (td, _, _) = res["jax"], res["port"]
            assert open(os.path.join(jd, ark), "rb").read() == \
                open(os.path.join(td, ark), "rb").read()
        else:
            same_arks(res, ark, close)
    with open(tmp_path / "ref", "w") as f:
        f.write("u0 YES NO\nu1 NO YES YES\n")
    with open(tmp_path / "hyp", "w") as f:
        f.write("u0 YES YES\nu1 NO YES\n")
    for extra in ([], ["--max-wer", "10"], ["--max-wer", "50"]):
        argv = ["compute-wer", str(tmp_path / "ref"), str(tmp_path / "hyp"),
                *extra]
        assert _call(tcli.main, argv) == _call(jmain, argv)


# --------------------------------------------------------- host commands

HOST_CASES = {
    "compute-cmvn-stats": lambda P, o: [
        "compute-cmvn-stats", f"ark:{P('feats.ark')}", f"ark:{o}/s.ark"],
    "compute-cmvn-stats-spk2utt": lambda P, o: [
        "compute-cmvn-stats", f"ark:{P('feats.ark')}", f"ark:{o}/s.ark",
        "--spk2utt", P("spk2utt")],
    "compute-cmvn-stats-two-channel": lambda P, o: [
        "compute-cmvn-stats-two-channel", P("reco2file_and_channel"),
        f"ark:{P('feats.ark')}", f"ark:{o}/s.ark",
        "--quieter-channel-weight", "0.1"],
    "modify-cmvn-stats": lambda P, o: [
        "modify-cmvn-stats", f"ark:{P('cmvn.ark')}", f"ark:{o}/s.ark"],
    "apply-cmvn-online": lambda P, o: [
        "apply-cmvn-online", f"ark:{P('feats.ark')}", f"ark:{o}/f.ark",
        "--cmn-window", "20", "--norm-vars"],
    "compute-vad": lambda P, o: [
        "compute-vad", f"ark:{P('feats.ark')}", f"ark:{o}/v.ark",
        "--vad-energy-threshold", "0.5"],
    "select-voiced-frames": lambda P, o: [
        "select-voiced-frames", f"ark:{P('feats.ark')}",
        f"ark:{P('vad.ark')}", f"ark:{o}/f.ark"],
    "create-split-from-vad": lambda P, o: [
        "create-split-from-vad", f"ark:{P('vad.ark')}", f"{o}/segments",
        "--max-voiced", "12"],
    "process-pitch-feats": lambda P, o: [
        "process-pitch-feats", f"ark:{P('pitch.ark')}", f"ark:{o}/p.ark"],
    "process-kaldi-pitch-feats": lambda P, o: [
        "process-kaldi-pitch-feats", f"ark:{P('pitch.ark')}",
        f"ark:{o}/p.ark"],
    "interpolate-pitch": lambda P, o: [
        "interpolate-pitch", f"ark:{P('pitch.ark')}", f"ark:{o}/p.ark",
        "--pov-threshold", "0.4"],
    "detect-sinusoids": lambda P, o: [
        "detect-sinusoids", P("wav.scp"), "--max-out", "3"],
    "wav-copy": lambda P, o: ["wav-copy", P("u2.wav"), f"{o}/c.wav"],
    "wav-to-duration": lambda P, o: ["wav-to-duration", P("wav.scp")],
    "extend-wav-with-silence": lambda P, o: [
        "extend-wav-with-silence", P("wav.scp"), f"{o}/ext",
        "--extend-secs", "0.25"],
    "extract-segments": lambda P, o: [
        "extract-segments", P("wav.scp"), P("segments"), f"{o}/seg"],
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_command_writes_jax_bytes(case, data, tmp_path):
    same_bytes(run_both(str(tmp_path), lambda o: HOST_CASES[case](data, o),
                        False))
