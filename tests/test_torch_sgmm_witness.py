"""The SGMM2 update witness: JAX's `update_sgmm2` and the port's on the
same model and statistics.

    python tests/test_torch_sgmm_witness.py chiprun_out/sgmm_witness.pkl

`chip_smoke.py` phase 28 saves the SGMM2 iteration (at egs/rm's sgmm2_4a
widths over the ladder's training frames) whose update lowered the
loglike per frame most: the model and the statistics before the update,
its flags and the aligned training frames. This script builds JAX's
`AmSgmm2` and `Sgmm2Accs` from them, applies JAX's update and the port's
(on the CPU) with the iteration's flags and with each flag alone, and
reports for each result the largest difference from the other package's
and the loglike per frame it gives on the training frames (the port's
accumulation on the CPU, which equals JAX's at 1e-9,
tests/test_torch_sgmm.py; JAX's own per-frame loop is too slow at this
width). The test below runs the same replay at tests/test_sgmm.py's size.
"""

import json
import pickle
import sys

import numpy as np
import torch

import kaldi_tpu.sgmm as js

import kaldi_tpu_torch.sgmm as ts
from kaldi_tpu_torch.params import sgmm2_from_jax


def jax_model(m: dict):
    """kaldi_tpu's AmSgmm2 holding the saved parameters."""
    out = object.__new__(js.AmSgmm2)
    o = m["offsets"]
    out.Sigma_inv = np.array(m["Sigma_inv"])
    out.M = np.array(m["M"])
    out.w = np.array(m["w"])
    out.N = None
    out.v = [list(m["V"][o[j]:o[j + 1]].copy()) for j in range(len(o) - 1)]
    out.c = [m["c"][o[j]:o[j + 1]].copy() for j in range(len(o) - 1)]
    out._update_derived()
    return out


def jax_accs(a: dict, offsets):
    """kaldi_tpu's Sgmm2Accs holding the saved statistics."""
    out = object.__new__(js.Sgmm2Accs)
    o = offsets
    out.gamma = [a["gamma"][o[j]:o[j + 1]].copy() for j in range(len(o) - 1)]
    out.y = [a["y"][o[j]:o[j + 1]].copy() for j in range(len(o) - 1)]
    out.Y, out.Q = np.array(a["Y"]), np.array(a["Q"])
    out.S_centered = np.array(a["S_centered"])
    out.tot_like, out.tot_frames = a["tot_like"], a["tot_frames"]
    return out


def port_accs(a: dict, model):
    """The port's Sgmm2Accs holding the saved statistics."""
    out = ts.Sgmm2Accs(model)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)  # noqa
    out.gamma, out.y, out.Y, out.Q = (t(a[k]) for k in ("gamma", "y", "Y",
                                                        "Q"))
    I, D, _ = a["S_centered"].shape
    out._S2 = t(a["S_centered"]).reshape(I, D * D)
    out._Sx = torch.zeros((I, D, D), dtype=torch.float64)
    out._tot_like = t(a["tot_like"])
    out._tot_frames = t(a["tot_frames"])
    return out


def loglike(model, x, pdfs, K: int) -> float:
    acc = ts.Sgmm2Accs(model)
    acc.accumulate(model, x, (np.arange(len(pdfs)), pdfs, np.ones(len(pdfs))),
                   K)
    return acc.tot_like / acc.tot_frames


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def witness(d: dict) -> dict:
    K = d["num_gselect"]
    x = d["x"].astype(np.float64)
    out = {"before": d["likes"][d["iter"]]}
    if d["iter"] + 1 < len(d["likes"]):
        out["card_after"] = d["likes"][d["iter"] + 1]
    for flags in [d["flags"]] + list(d["flags"]):
        jm = jax_model(d["model"])
        js.update_sgmm2(jm, jax_accs(d["accs"], d["model"]["offsets"]),
                        flags)
        tm = sgmm2_from_jax(jax_model(d["model"]), "cpu")
        ts.update_sgmm2(tm, port_accs(d["accs"], tm), flags)
        jt = sgmm2_from_jax(jm, "cpu")
        out[flags] = dict(
            jax=loglike(jt, x, d["pdfs"], K),
            port_cpu=loglike(tm, x, d["pdfs"], K),
            rel={k: _max_rel(getattr(tm, k).numpy(), getattr(jt, k).numpy())
                 for k in ("V", "c", "M", "w", "Sigma_inv")},
            max_abs_v=float(np.abs(jt.V.numpy()).max()))
    return out


def main(path: str) -> int:
    with open(path, "rb") as f:
        d = pickle.load(f)
    out = witness(d)
    print(f"SGMM2 witness, iteration {d['iter']} ({d['flags']}) of "
          f"{d['card']}'s run, loglike/frame by iteration {d['likes']}:")
    print(json.dumps(out))
    return 0


def test_witness_replays_an_update_at_test_sgmm_size():
    """The replay at tests/test_sgmm.py's size (split to 6 substates): the
    saved-state layout round-trips and JAX's and the port's updates from
    it agree at 1e-9, each with the iteration's flags and each flag
    alone."""
    import chip_smoke as cs
    su = cs.sgmm_small_setup("cpu")
    m = su["model"]
    x, post = su["feats"], su["post"]
    pdfs = np.array([fr[0][0] for fr in post])
    entries = (np.arange(len(pdfs)), pdfs, np.ones(len(pdfs)))
    acc = ts.Sgmm2Accs(m)
    acc.accumulate(m, x, entries, 3)
    a = lambda t: t.numpy()  # noqa: E731
    d = dict(iter=0, flags="vwc", likes=[acc.tot_like / acc.tot_frames],
             num_gselect=3, x=x.astype(np.float32), pdfs=pdfs,
             model=dict(Sigma_inv=a(m.Sigma_inv), M=a(m.M), w=a(m.w),
                        V=a(m.V), c=a(m.c), offsets=m.offsets),
             accs=dict(gamma=a(acc.gamma), y=a(acc.y), Y=a(acc.Y),
                       Q=a(acc.Q), S_centered=a(acc.S_centered),
                       tot_like=acc.tot_like, tot_frames=acc.tot_frames))
    back = port_accs(d["accs"], m)
    for k in ("gamma", "y", "Y", "Q", "S_centered"):
        assert torch.equal(getattr(back, k), getattr(acc, k))
    out = witness(d)
    assert set(out) == {"before", "vwc", "v", "w", "c"}
    for flags in ("vwc", "v", "w", "c"):
        r = out[flags]
        assert max(r["rel"].values()) <= 1e-9, (flags, r)
        assert abs(r["jax"] - r["port_cpu"]) <= 1e-9 * abs(r["jax"])
    # each flag alone does not lower the loglike, but "vwc" from one
    # accumulation does, in JAX as in the port: w's steps take the new v
    # with the old posteriors (the reference's schedule, ROADMAP.md §3)
    for flags in ("v", "w", "c"):
        assert out[flags]["jax"] >= out["before"] - 1e-9
    assert out["vwc"]["jax"] < out["before"] < out["v"]["jax"]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
