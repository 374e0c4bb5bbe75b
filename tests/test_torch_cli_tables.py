"""Port parity: the first CLI slice's table, matrix, vector, transform,
data-dir and probe subcommands (kaldi_tpu_torch/cli.py, cli_misc.py)
against kaldi_tpu's CLI on the same seeded files, on the CPU.

All are host commands: each case runs both packages' `main` and asserts
byte-equal output files (arks, scps, HTK and Sphinx files, text), equal
stdout and equal exit codes, through tests/test_torch_cli_features.py's
harness. test_cli_more.py's, test_util_cli.py's, test_cli_leftovers2.py's
and test_misc_cli.py's cases for this slice's names, on the port; then
the probes: `info` prints JAX's keys (torch's version in place of
JAX's), `cuda-compiled` and `cuda-gpu-available` exit as torch answers.
"""

import json

import numpy as np
import pytest
import torch

from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io.kaldi_io import write_ark
from test_torch_cli_features import _call, run_both, same_bytes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded feature, matrix, vector, alignment, transform, range and
    segment files."""
    d = tmp_path_factory.mktemp("in")
    P = lambda *n: str(d.joinpath(*n))                       # noqa: E731
    rng = np.random.RandomState(23)
    feats = {f"u{i}": (rng.randn(T, 6) * 2 + 1).astype(np.float32)
             for i, T in enumerate((21, 34, 13))}
    write_ark(P("feats.ark"), feats, scp_path=P("feats.scp"))
    write_ark(P("feats_b.ark"), {k: (v[:, :4] * 0.5 + 0.25)
                                 .astype(np.float32)
                                 for k, v in feats.items() if k != "u2"})
    write_ark(P("feats_t.ark"), feats, binary=False)
    write_ark(P("short.ark"), {k: v[:-1] for k, v in feats.items()})
    write_ark(P("vecs.ark"), {k: rng.randn(3).astype(np.float32)
                              for k in ("u0", "u1")})
    write_ark(P("vecs2.ark"), {k: rng.randn(3).astype(np.float32)
                               for k in ("u1", "u2")})
    write_ark(P("w1.ark"), {"a": rng.uniform(0, 1, 5).astype(np.float32),
                            "b": rng.uniform(0, 1, 3).astype(np.float32)})
    write_ark(P("w2.ark"), {"a": rng.uniform(0, 1, 5).astype(np.float32),
                            "b": rng.uniform(0, 1, 3).astype(np.float32)})
    write_ark(P("ali.ark"), {k: rng.randint(0, 6, len(v)).astype(np.int32)
                             for k, v in feats.items()})
    write_ark(P("mats1.ark"), {"x": rng.randn(3, 4).astype(np.float32),
                               "y": rng.randn(2, 2).astype(np.float32)})
    write_ark(P("mats2.ark"), {"x": rng.randn(3, 4).astype(np.float32),
                               "z": rng.randn(1, 5).astype(np.float32)})
    write_ark(P("A.ark"), {"t": rng.randn(4, 7).astype(np.float32)})
    write_ark(P("B_lin.ark"), {"t": rng.randn(6, 6).astype(np.float32)})
    write_ark(P("B_aff.ark"), {"t": rng.randn(6, 7).astype(np.float32)})
    write_ark(P("B_rect.ark"), {"t": rng.randn(6, 4).astype(np.float32)})
    write_ark(P("vt.ark"), {"t": rng.randn(2, 4).astype(np.float32)})
    with open(P("ranges"), "w") as f:
        f.write("r0 u0 2 9\nr1 u1 0 30\nbad line\nr2 zz 0 3\n")
    with open(P("fsegments"), "w") as f:
        f.write("s0 u0 0.03 0.15\ns1 u1 0.10 0.33\ns2 u2 0.20 0.20\n")
    with open(P("ivv.txt"), "w") as f:
        f.write("a 1 2 ; 3\nb 4 ;\n\nc 5 6 7")
    with open(P("text.scp"), "w") as f:
        f.write("".join(f"utt{k:02d} x{k}\n" for k in (7, 3, 11, 0, 5, 9,
                                                         1)))
    with open(P("utt2spk"), "w") as f:
        f.write("u3 s2\nu1 s1\nu2 s1\nu0 s2\n")
    with open(P("ref"), "w") as f:
        f.write("u0 a b c\nu1 d e\n")
    with open(P("hyp"), "w") as f:
        f.write("u0 a x c\nu1 d e f\n")
    return P


def _ark(P, n):
    return f"ark:{P(n)}"


CASES = {
    "copy-feats": lambda P, o: ["copy-feats", _ark(P, "feats.ark"),
                                f"ark,scp:{o}/c.ark,{o}/c.scp"],
    "copy-feats-compress": lambda P, o: [
        "copy-feats", f"scp:{P('feats.scp')}", f"ark:{o}/c.ark",
        "--compress"],
    "copy-feats-text": lambda P, o: ["copy-feats", _ark(P, "feats_t.ark"),
                                     f"ark,t:{o}/c.txt"],
    "copy-feats-to-htk": lambda P, o: [
        "copy-feats-to-htk", _ark(P, "feats.ark"), f"{o}/htk",
        "--ext", ".htk", "--sample-period", "80000"],
    "copy-feats-to-sphinx": lambda P, o: [
        "copy-feats-to-sphinx", _ark(P, "feats.ark"), f"{o}/sphinx"],
    "paste-feats": lambda P, o: [
        "paste-feats", _ark(P, "feats.ark"), _ark(P, "short.ark"),
        f"ark:{o}/p.ark", "--length-tolerance", "1"],
    "paste-feats-strict": lambda P, o: [
        "paste-feats", _ark(P, "feats.ark"), _ark(P, "short.ark"),
        f"ark:{o}/p.ark", "--compress"],
    "append-feats": lambda P, o: [
        "append-feats", _ark(P, "feats.ark"), _ark(P, "short.ark"),
        f"ark:{o}/a.ark"],
    "append-vector-to-feats": lambda P, o: [
        "append-vector-to-feats", _ark(P, "feats.ark"), _ark(P, "vecs.ark"),
        f"ark:{o}/a.ark"],
    "select-feats": lambda P, o: ["select-feats", "0-2,5",
                                  _ark(P, "feats.ark"), f"ark:{o}/s.ark"],
    "subset-feats": lambda P, o: ["subset-feats", _ark(P, "feats.ark"),
                                  f"ark:{o}/s.ark", "--n", "2"],
    "subset-feats-last": lambda P, o: [
        "subset-feats", _ark(P, "feats.ark"), f"ark:{o}/s.ark", "--n", "2",
        "--last", "--compress"],
    "subsample-feats": lambda P, o: [
        "subsample-feats", _ark(P, "feats.ark"), f"ark:{o}/s.ark",
        "--n", "3", "--offset", "1"],
    "shift-feats-forward": lambda P, o: [
        "shift-feats", _ark(P, "feats.ark"), f"ark:{o}/s.ark",
        "--shift", "2"],
    "shift-feats-back": lambda P, o: [
        "shift-feats", _ark(P, "feats.ark"), f"ark:{o}/s.ark",
        "--shift=-3"],
    "reverse-feats": lambda P, o: ["reverse-feats", _ark(P, "feats.ark"),
                                   f"ark:{o}/r.ark"],
    "remove-mean": lambda P, o: ["remove-mean", _ark(P, "feats.ark"),
                                 f"ark:{o}/r.ark"],
    "extract-rows": lambda P, o: ["extract-rows", P("ranges"),
                                  _ark(P, "feats.ark"), f"ark:{o}/r.ark"],
    "extract-feature-segments": lambda P, o: [
        "extract-feature-segments", _ark(P, "feats.ark"), P("fsegments"),
        f"ark:{o}/s.ark", "--frame-shift", "0.01"],
    "feat-to-dim": lambda P, o: ["feat-to-dim", _ark(P, "feats.ark")],
    "feat-to-len": lambda P, o: ["feat-to-len", f"scp:{P('feats.scp')}"],
    "compare-feats-same": lambda P, o: [
        "compare-feats", _ark(P, "feats.ark"), _ark(P, "feats_t.ark")],
    "compare-feats-differ": lambda P, o: [
        "compare-feats", _ark(P, "feats.ark"), _ark(P, "short.ark"),
        "--threshold", "0.5"],
    "copy-matrix": lambda P, o: ["copy-matrix", _ark(P, "mats1.ark"),
                                 f"ark:{o}/m.ark", "--scale", "-0.5"],
    "copy-matrix-compress": lambda P, o: [
        "copy-matrix", _ark(P, "feats.ark"), f"ark:{o}/m.ark",
        "--compress"],
    "copy-vector": lambda P, o: ["copy-vector", _ark(P, "vecs.ark"),
                                 f"ark,t:{o}/v.txt"],
    "copy-int-vector": lambda P, o: ["copy-int-vector", _ark(P, "ali.ark"),
                                     f"ark:{o}/a.ark"],
    "copy-int-vector-vector": lambda P, o: [
        "copy-int-vector-vector", f"ark:{P('ivv.txt')}", f"ark:{o}/c.txt"],
    "matrix-dim": lambda P, o: ["matrix-dim", _ark(P, "mats1.ark")],
    "matrix-sum": lambda P, o: ["matrix-sum", f"ark:{o}/s.ark",
                                _ark(P, "mats1.ark"), _ark(P, "mats2.ark")],
    "sum-matrices-average": lambda P, o: [
        "sum-matrices", f"ark:{o}/s.ark", _ark(P, "mats1.ark"),
        _ark(P, "mats2.ark"), "--average"],
    "matrix-sum-rows": lambda P, o: ["matrix-sum-rows", _ark(P, "feats.ark"),
                                     f"ark:{o}/s.ark"],
    "matrix-logprob": lambda P, o: [
        "matrix-logprob", _ark(P, "feats.ark"), _ark(P, "ali.ark"),
        f"ark:{o}/m.ark"],
    "duplicate-matrix": lambda P, o: [
        "duplicate-matrix", _ark(P, "mats1.ark"), f"ark:{o}/d1.ark",
        f"ark,t:{o}/d2.txt"],
    "vector-scale": lambda P, o: ["vector-scale", _ark(P, "vecs.ark"),
                                  f"ark:{o}/v.ark", "--scale", "3.5"],
    "vector-sum": lambda P, o: ["vector-sum", f"ark:{o}/v.ark",
                                _ark(P, "vecs.ark"), _ark(P, "vecs2.ark")],
    "vector-sum-average": lambda P, o: [
        "vector-sum", f"ark:{o}/v.ark", _ark(P, "vecs.ark"),
        _ark(P, "vecs2.ark"), "--average"],
    "dot-weights": lambda P, o: ["dot-weights", _ark(P, "w1.ark"),
                                 _ark(P, "w2.ark"), f"ark:{o}/d.ark"],
    "reverse-weights": lambda P, o: ["reverse-weights", _ark(P, "w1.ark"),
                                     f"ark:{o}/r.ark"],
    "reverse-weights-off": lambda P, o: [
        "reverse-weights", _ark(P, "w1.ark"), f"ark:{o}/r.ark",
        "--reverse", "false"],
    "transform-vec-linear": lambda P, o: [
        "transform-vec", P("vt.ark"), _ark(P, "vecs.ark"),
        f"ark:{o}/v.ark"],
    "compose-transforms-linear": lambda P, o: [
        "compose-transforms", P("A.ark"), P("B_lin.ark"), f"{o}/c.ark"],
    "compose-transforms-affine": lambda P, o: [
        "compose-transforms", P("A.ark"), P("B_aff.ark"), f"{o}/c.ark"],
    "compose-transforms-b-is-affine": lambda P, o: [
        "compose-transforms", P("A.ark"), P("B_rect.ark"), f"{o}/c.ark",
        "--b-is-affine"],
    "extend-transform-dim": lambda P, o: [
        "extend-transform-dim", P("B_aff.ark"), f"{o}/e.ark",
        "--new-dimension", "9"],
    "est-pca": lambda P, o: ["est-pca", _ark(P, "feats.ark"),
                             f"{o}/pca.ark", "--dim", "4"],
    "est-pca-normalized": lambda P, o: [
        "est-pca", _ark(P, "feats.ark"), f"{o}/pca.ark", "--dim", "3",
        "--normalize-variance", "--no-normalize-mean"],
    "split-scp": lambda P, o: ["split-scp", P("text.scp"), "3",
                               f"{o}/part.JOB.scp"],
    "utt2spk-to-spk2utt": lambda P, o: ["utt2spk-to-spk2utt", P("utt2spk")],
    "compute-wer": lambda P, o: ["compute-wer", P("ref"), P("hyp")],
    "compute-wer-max-wer": lambda P, o: ["compute-wer", P("ref"), P("hyp"),
                                         "--max-wer", "20"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_command_writes_jax_bytes(case, data, tmp_path):
    same_bytes(run_both(str(tmp_path), lambda o: CASES[case](data, o),
                        False))


def test_info_prints_jax_keys_for_torch():
    import kaldi_tpu
    from kaldi_tpu.cli import main as jmain
    want = json.loads(_call(jmain, ["info"])[0])
    got, code = _call(tcli.main, ["info"])
    got = json.loads(got)
    assert code == 0
    assert sorted(got) == sorted(k if k != "jax" else "torch" for k in want)
    assert got["torch"] == torch.__version__
    assert got["version"] == kaldi_tpu.__version__
    assert got["devices"] == ([f"cuda:{i}" for i in
                               range(torch.cuda.device_count())]
                              if torch.cuda.is_available() else ["cpu"])
    assert got["native_ark_io"] in (True, False)


@pytest.mark.parametrize("name,ok", [
    ("cuda-compiled", lambda: bool(torch.version.cuda)),
    ("cuda-gpu-available", torch.cuda.is_available)])
def test_card_probes_answer_for_torch(name, ok):
    assert _call(tcli.main, [name])[1] == (0 if ok() else 1)
