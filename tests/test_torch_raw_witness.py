"""The raw-fMLLR witness: JAX's `estimate_fmllr_raw` and the port's on the
same accumulators.

    python tests/test_torch_raw_witness.py chiprun_out/raw_fmllr_witness.pkl

`chip_smoke.py` phase 28 saves, per ladder test speaker, the raw-fMLLR
accumulators it built on the card (spliced raw windows, the aligned pdfs,
the gaussian posteriors), the card's W and gain, the LDA+MLLT model and
its square LDA. This script rebuilds JAX's `FmllrRawAccs` from them
(per-frame means and inverse variances of the aligned pdf, as JAX's
`accumulate_from_alignment` stores them) and runs JAX's estimator and
the port's (on the CPU) on the same accumulators, then reports per
speaker: the largest difference of each W from the card's, each side's
auxiliary gain per frame, the variance of the square LDA's rejected rows
before and after each W, and the WER that each side's transforms give
through the ladder's decoder (make_hclg_flat + CsrBeamDecoder on the
CPU). The test below runs the same comparison on test_fmllr_raw.py's
accumulators.
"""

import json
import pickle
import sys

import numpy as np
import torch

from kaldi_tpu.transform import fmllr_raw as jraw

from kaldi_tpu_torch.ops.delta import splice_frames
from kaldi_tpu_torch.params import fmllr_raw_accs_from_jax
from kaldi_tpu_torch.transform import fmllr_raw as traw
from kaldi_tpu_torch.transform.fmllr import apply_affine_transform


def jax_accs(d: int, L: int, R: int, X, pdfs, gam, pdf_params):
    """JAX's `FmllrRawAccs` holding windows X [T, n d], each frame's pdf's
    means and inverse variances, and its posteriors (padded gam [T, M],
    cut to the pdf's gaussians)."""
    accs = jraw.FmllrRawAccs(d, L, R)
    for t, p in enumerate(np.asarray(pdfs)):
        _w, means, var = pdf_params[int(p)]
        accs.windows.append(np.asarray(X[t], np.float32))
        accs.means.append(means)
        accs.inv_vars.append(1.0 / var)
        accs.gammas.append(np.asarray(gam[t, :len(means)], np.float32))
    return accs


def compare(accs, transform) -> dict:
    """JAX's and the port's (CPU) estimate from the same accumulators."""
    Wj, gj = jraw.estimate_fmllr_raw(accs, transform)
    Wt, gt = traw.estimate_fmllr_raw(fmllr_raw_accs_from_jax(accs, "cpu"),
                                     transform)
    return dict(W_jax=np.asarray(Wj), gain_jax=float(gj), W_port=Wt,
                gain_port=float(gt))


def rejected_variance(raw: list, W, full, lda_dim: int, L: int, R: int):
    rows = full[lda_dim:]
    ys = []
    for f in raw:
        x = apply_affine_transform(f, W, "cpu")
        sp = splice_frames(x, L, R).numpy().astype(np.float64)
        ys.append(sp @ rows[:, :-1].T + rows[:, -1])
    return float(np.concatenate(ys).var(axis=0).mean())


def decode_wer(data: dict, transforms: dict) -> float:
    """WER of the test set with each speaker's raw transform applied, then
    spliced and projected, through the ladder's LDA+MLLT decoder."""
    import chip_smoke as cs
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.steps.mono import MonoModel
    lang = prepare_lang(Lexicon.parse(data["lexicon"]), ["SIL"], "SIL",
                        num_sil_states=3)
    m = data["model"]
    model = MonoModel(AmDiagGmm([DiagGmm(*p) for p in m["pdfs"]], "cpu"),
                      m["trans_model"], m["ctx_dep"], lang)
    dec, _s = cs.ladder_decoder(model, data["arpa"],
                                CsrBeamOpts(**data["dopts"]), "cpu")
    L, R = data["splice"]
    fl = []
    for f, s in zip(data["test_raw"], data["spk"]):
        x = apply_affine_transform(f, transforms[s], "cpu")
        fl.append(apply_affine_transform(splice_frames(x, L, R),
                                         data["transform"]).numpy())
    fb, nf = cs.pad_batch(fl)
    res = dec.decode(model.am.loglikes(fb), nf)
    return cs.wer(data["refs"], [[lang.words.sym(w) for w in r[0]] if r
                                 else [] for r in res])


def witness(data: dict, decode: bool = True) -> dict:
    d = data["test_raw"][0].shape[1] if "test_raw" in data else data["d"]
    L, R = data["splice"]
    out = {}
    for s, sp in data["speakers"].items():
        accs = jax_accs(d, L, R, sp["X"], sp["pdfs"], sp["gam"],
                        data["model"]["pdfs"])
        r = compare(accs, data["transform"])
        r.update(gain_card=float(sp["gain"]), frames=len(sp["pdfs"]),
                 dW_jax_card=float(np.abs(r["W_jax"] - sp["W"]).max()),
                 dW_port_card=float(np.abs(r["W_port"] - sp["W"]).max()),
                 dW_jax_port=float(np.abs(r["W_jax"] - r["W_port"]).max()))
        if "full_lda" in data:
            raw = [f for f, s2 in zip(data["test_raw"], data["spk"])
                   if s2 == s]
            lda_dim = data["transform"].shape[0]
            r["rejected"] = {
                k: rejected_variance(raw, W, data["full_lda"], lda_dim, L, R)
                for k, W in (("identity", np.eye(d, d + 1)),
                             ("jax", r["W_jax"]), ("card", sp["W"]))}
        out[s] = r
    if decode:
        out["wer"] = {k: decode_wer(data, {s: out[s][f"W_{k}"] if k != "card"
                                           else data["speakers"][s]["W"]
                                           for s in data["speakers"]})
                      for k in ("jax", "port", "card")}
        out["wer"]["si"] = decode_wer(data, {s: np.eye(d, d + 1)
                                             for s in data["speakers"]})
    return out


def main(path: str) -> int:
    with open(path, "rb") as f:
        data = pickle.load(f)
    out = witness(data)
    print(f"raw-fMLLR witness on the accumulators of {data['card']}:")
    for s, r in out.items():
        if s == "wer":
            continue
        print(json.dumps({"speaker": s, "frames": r["frames"],
                          "gain_card": r["gain_card"],
                          "gain_jax": r["gain_jax"],
                          "gain_port_cpu": r["gain_port"],
                          "max_dW_jax_vs_card": r["dW_jax_card"],
                          "max_dW_port_cpu_vs_card": r["dW_port_card"],
                          "max_dW_jax_vs_port_cpu": r["dW_jax_port"],
                          "rejected_variance": r.get("rejected")}))
    print(json.dumps({"wer": out["wer"], "card_wer": data["wer"]}))
    return 0


def test_witness_on_test_fmllr_raw_accumulators():
    """The witness's comparison on test_fmllr_raw.py's accumulators (the
    port's, carried into JAX's layout): JAX's and the port's gains agree
    within 1e-3 relative, and the layout round-trips."""
    from test_torch_adaptation import _raw_case
    c = _raw_case()
    ta = traw.FmllrRawAccs(3, 1, 1, "cpu")
    ta.accumulate_from_alignment(c["tam"], c["distorted"][:400], c["Tmat"],
                                 c["pid"][:400])
    X, _mu, _iv, gam = ta.stacked()
    params = [(g.weights, g.means, g.vars) for g in c["tam"].pdfs]
    data = dict(splice=(1, 1), transform=c["Tmat"], d=3, model=dict(
        pdfs=params), speakers={"s": dict(
            X=X.numpy(), pdfs=c["pid"][:400], gam=gam.numpy(),
            W=np.eye(3, 4, dtype=np.float32), gain=0.0)})
    out = witness(data, decode=False)["s"]
    assert abs(out["gain_port"] - out["gain_jax"]) <= 1e-3 * abs(
        out["gain_jax"])
    back = fmllr_raw_accs_from_jax(jax_accs(3, 1, 1, X.numpy(),
                                            c["pid"][:400], gam.numpy(),
                                            params), "cpu").stacked()
    for a, b in zip(back, ta.stacked()):
        assert torch.equal(a, b)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
