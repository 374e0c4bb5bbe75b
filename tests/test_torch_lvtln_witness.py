"""The LVTLN witness: JAX's `LinearVtln.select_class` and the port's on
the same class transforms and per-speaker fMLLR statistics.

    python tests/test_torch_lvtln_witness.py chiprun_out/lvtln_witness.pkl

`chip_smoke.py` phase 28 (b) saves the 13 class transforms it trained on
the card (warps 0.88-1.12), and per ladder test speaker the fMLLR
statistics of its first-pass alignment, the class the card selected and
the card's auxiliary per class. This script loads them into JAX's
`LinearVtln` (kaldi_tpu/transform/lvtln.py:36) and the port's on the
CPU and reports per speaker each side's class, its auxiliary per class
over the identity class's per frame, and the largest differences. The
test below runs the same comparison on test_torch_adaptation.py's LVTLN
case (three warp classes over 4 dims, statistics of a warped speaker)
with the port's own selection standing in for the card's.
"""

import json
import sys

import numpy as np

from kaldi_tpu.transform import fmllr as jfmllr
from kaldi_tpu.transform import lvtln as jlvtln
from kaldi_tpu_torch.transform import fmllr as tfmllr
from kaldi_tpu_torch.transform import lvtln as tlvtln


def _stats(mod, sp: dict, dim: int):
    st = mod.FmllrStats(dim)
    st.beta, st.K, st.G = sp["beta"], np.array(sp["K"]), np.array(sp["G"])
    return st


def witness(data: dict) -> dict:
    """-> per speaker: the classes (card, JAX, port on the CPU), each
    side's auxiliary per class over the identity's per frame, and the
    largest auxiliary and transform differences from JAX's."""
    import torch
    A = np.asarray(data["A"], np.float64)
    dim = A.shape[1]
    jl = jlvtln.LinearVtln(dim, data["warps"])
    jl.A = A.copy()
    tl = tlvtln.LinearVtln(dim, data["warps"], "cpu")
    tl.A = torch.as_tensor(A)
    d = data["default_class"]
    out = {}
    for s, sp in data["speakers"].items():
        cj, Wj, aj = jl.select_class(_stats(jfmllr, sp, dim))
        ct, Wt, at = tl.select_class(_stats(tfmllr, sp, dim))
        aj, at, ac = np.asarray(aj), np.asarray(at), np.asarray(sp["aux"])
        scale = max(np.abs(aj).max(), 1e-30)
        out[s] = dict(
            frames=sp["beta"], cls_card=int(sp["cls"]), cls_jax=int(cj),
            cls_port=int(ct), warp_jax=data["warps"][cj],
            aux_jax_per_frame=list((aj - aj[d]) / sp["beta"]),
            aux_card_per_frame=list((ac - ac[d]) / sp["beta"]),
            d_aux_card_jax=float(np.abs(ac - aj).max() / scale),
            d_aux_port_jax=float(np.abs(at - aj).max() / scale),
            dW_card_jax=float(np.abs(np.asarray(sp["W"]) - Wj).max()),
            dW_port_jax=float(np.abs(Wt - Wj).max()))
    return out


def test_lvtln_witness_at_cpu_size():
    """The comparison on test_torch_adaptation.py's case: the port's
    selection (standing in for the card's) and JAX's agree class for
    class, auxiliaries within 1e-9 relative, and pick the warped class."""
    import chip_smoke as cs
    from test_torch_adaptation import _lvtln_case
    from kaldi_tpu_torch import params as P
    maps, X, stats = _lvtln_case()
    lv = tlvtln.LinearVtln(4, [0.9, 1.0, 1.1], "cpu")
    for c, M in maps.items():
        lv.train_class(c, X, X @ M.T)
    data = cs.lvtln_witness_data(lv, {"s1": P.fmllr_stats_from_jax(stats)})
    out = witness(data)["s1"]
    assert out["cls_card"] == out["cls_jax"] == out["cls_port"] == 2
    assert out["d_aux_card_jax"] <= 1e-9 and out["d_aux_port_jax"] <= 1e-9
    assert out["dW_card_jax"] <= 1e-9


if __name__ == "__main__":
    import pickle
    with open(sys.argv[1], "rb") as f:
        res = witness(pickle.load(f))
    print(json.dumps(res, indent=1))
