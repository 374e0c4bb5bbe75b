"""The SAT witness: JAX's fMLLR estimate and model update of one
`train_sat` iteration against the card's, on the card's inputs.

    python tests/test_torch_sat_witness.py chiprun_out/sat_witness.pkl

`chip_smoke.py` phase 20 records the port's `train_sat` at its first fMLLR
iteration (`SatWitness`): the model, the current features, alignments
and speakers that `estimate_speaker_transforms` received and the speaker
transforms it returned; then that iteration's `_update`: the model
before, the accumulators and the model after. This script replays
kaldi_tpu/steps/sat.py's estimate (`estimate_speaker_transforms`, :50)
and kaldi_tpu/steps/mono.py's `_update` on them on the CPU, and the
port's estimate on the CPU beside them, and reports per speaker the
largest difference of each W from JAX's, each W's auxiliary gain per
frame on JAX's own statistics, and the largest difference of the
updated model's parameters. The test below records and replays the same
iteration of a CPU run on chip_smoke.sat_corpus (SAT_SMALL).
"""

import json
import sys
import types

import numpy as np

from kaldi_tpu.gmm.am_gmm import AmDiagGmm as JAm
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.gmm.estimation import AccumAmDiagGmm as JAccum
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.steps import sat as jsat
from kaldi_tpu.transform import fmllr as jfmllr


def _jax_model(pdfs, id2pdf):
    return types.SimpleNamespace(
        am=JAm([JDiag(*p) for p in pdfs]),
        trans_model=types.SimpleNamespace(
            id2pdf_array=np.asarray(id2pdf),
            mle_update=lambda counts: None))


def _speaker_stats(model, utts, align) -> dict:
    """JAX's per-speaker statistics, as estimate_speaker_transforms
    gathers them."""
    tid2pdf = model.trans_model.id2pdf_array
    out = {}
    for (_u, f, spk), tids in zip(utts, align):
        if tids is None:
            continue
        T = min(len(tids), f.shape[0])
        st = out.setdefault(spk, jfmllr.FmllrStats(f.shape[1]))
        st.accumulate_from_alignment(model.am, f[:T], tid2pdf[tids[:T]])
    return out


def _gain(W, st) -> float:
    D = W.shape[0]
    ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    return (jfmllr.fmllr_auxf(np.asarray(W, np.float64), st)
            - jfmllr.fmllr_auxf(ident, st)) / st.beta


def replay_estimate(e: dict) -> dict:
    """JAX's (and the port's, on the CPU) estimate on the recorded inputs
    -> per speaker: frames, the gains per frame on JAX's statistics of
    the card's, JAX's and the port's W, and the largest W differences."""
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm as TAm
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm as TDiag
    from kaldi_tpu_torch.steps import sat as tsat
    jm = _jax_model(e["pdfs"], e["id2pdf"])
    utts = [(u, f, None, s) for u, f, s in e["utts"]]
    align = [None if a is None else (a,) for a in e["align"]]
    jw = jsat.estimate_speaker_transforms(jm, utts, align, e["min_count"])
    tm = types.SimpleNamespace(am=TAm([TDiag(*p) for p in e["pdfs"]], "cpu"),
                               trans_model=jm.trans_model)
    tw = tsat.estimate_speaker_transforms(tm, utts, align, e["min_count"])
    stats = _speaker_stats(jm, e["utts"], e["align"])
    out = {"speakers_card": sorted(e["delta"]), "speakers_jax": sorted(jw),
           "speakers_port": sorted(tw)}
    for s in sorted(jw):
        st = stats[s]
        card = e["delta"].get(s)
        out[s] = dict(
            frames=float(st.beta), gain_jax=_gain(jw[s], st),
            gain_card=None if card is None else _gain(card, st),
            gain_port=None if s not in tw else _gain(tw[s], st),
            dW_card_jax=None if card is None else float(
                np.abs(np.asarray(card) - jw[s]).max()),
            dW_port_jax=None if s not in tw else float(
                np.abs(tw[s] - jw[s]).max()))
    return out


def replay_update(u: dict, id2pdf) -> dict:
    """JAX's `_update` of the recorded model from the recorded
    accumulators -> the largest differences from the card's model after
    it (weights, means, variances, relative to each's largest value) and
    the gaussian counts."""
    jm = _jax_model(u["before"], id2pdf)
    acc = JAccum(jm.am)
    for a, (occ, m, v) in zip(acc.accs, u["accs"]):
        a.occ, a.mean_acc, a.var_acc = occ.copy(), m.copy(), v.copy()
    opts = types.SimpleNamespace(
        min_gaussian_occupancy=u["min_gaussian_occupancy"],
        perturb_factor=u["perturb_factor"], power=u["power"])
    jmono._update(jm, acc, None, opts, u["target"])
    out = {"gauss_jax": int(sum(p.num_gauss for p in jm.am.pdfs)),
           "gauss_card": int(sum(len(w) for w, _m, _v in u["after"]))}
    if out["gauss_jax"] != out["gauss_card"]:
        return out
    for i, name in enumerate(("weights", "means", "vars")):
        got = np.concatenate([np.ravel(p[i]) for p in u["after"]])
        want = np.concatenate([np.ravel(getattr(p, name))
                               for p in jm.am.pdfs])
        out[f"d_{name}"] = float(np.abs(got - want).max()
                                 / np.abs(want).max())
    return out


def witness(data: dict) -> dict:
    return {"estimate": replay_estimate(data["estimate"]),
            "update": replay_update(data["update"],
                                    data["estimate"]["id2pdf"])}


def test_sat_witness_at_cpu_size():
    """A CPU run of the port's train_sat on sat_corpus, its first fMLLR
    iteration recorded and replayed through JAX: the same speakers, each
    port transform as good on JAX's statistics as JAX's own (auxiliary
    gain per frame within 1e-4), and JAX's update of the recorded
    accumulators the port's model (1e-9 relative)."""
    import chip_smoke as cs
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.steps import mono as tmono
    from kaldi_tpu_torch.steps import sat as tsat
    train, _test, _refs = cs.sat_corpus("cpu")
    lang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                        num_sil_states=3)
    m = tmono.train_mono(lang, [(u, f, w) for (u, f, w, _s) in train],
                         tmono.MonoTrainOpts(**cs.SAT_LDA_MONO), device="cpu")
    with cs.SatWitness() as sw:
        tsat.train_sat(lang, train, m, tsat.SatTrainOpts(**cs.SAT_SMALL))
    out = witness(sw.data)
    e = out["estimate"]
    assert e["speakers_card"] == e["speakers_jax"] == e["speakers_port"] \
        == ["s0", "s1", "s2"]
    for s in e["speakers_jax"]:
        assert e[s]["gain_jax"] > 0
        assert abs(e[s]["gain_card"] - e[s]["gain_jax"]) <= 1e-4, (s, e[s])
        assert e[s]["dW_port_jax"] == e[s]["dW_card_jax"]
    u = out["update"]
    assert u["gauss_jax"] == u["gauss_card"]
    assert max(u["d_weights"], u["d_means"], u["d_vars"]) <= 1e-9, u


if __name__ == "__main__":
    import pickle
    with open(sys.argv[1], "rb") as f:
        print(json.dumps(witness(pickle.load(f)), indent=1))
