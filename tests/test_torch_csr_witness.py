"""The CSR witness: JAX's CsrBeamDecoder against the card's on one of
the triphone ladder's test batches.

    python tests/test_torch_csr_witness.py chiprun_out/csr_witness.pkl

`chip_smoke.py` phase 20 records its tri rung's decode (`csr_witness_data`):
the packed HCLG's arrays, each test utterance's loglikes, LADDER_DECODE
(beam 14, max_active 1024, expand_budget 16384) and the card's words,
costs and overflow. This script replays the batch through
kaldi_tpu/decoder/csr_beam.py's CsrBeamDecoder on the CPU, and the port's
on the CPU beside it, and reports how many utterances each gives the
card's words, the largest cost difference and the overflow counts. The
test below records and replays a CPU decode of chip_smoke's yesno system
(its three test waves) at the same options, the port on the CPU standing
in for the card.
"""

import dataclasses
import json
import pickle
import sys

import numpy as np

from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder as JCsr
from kaldi_tpu.decoder.csr_beam import CsrBeamOpts as JOpts
from kaldi_tpu.decoder.graph_pack import PackedGraph as JPackedGraph


def _batch(w: dict):
    """The witness's loglikes padded to [B, T, P] with their frame counts."""
    nf = np.array([len(x) for x in w["loglikes"]], np.int32)
    P = w["loglikes"][0].shape[1]
    ll = np.zeros((len(nf), int(nf.max()), P), np.float32)
    for b, x in enumerate(w["loglikes"]):
        ll[b, : len(x)] = x
    return ll, nf


def _compare(name: str, res, w: dict) -> dict:
    words = [None if r is None else [int(x) for x in r[0]] for r in res]
    costs = [None if r is None else float(r[2]) for r in res]
    same = [a == b for a, b in zip(words, w["words"])]
    dc = [abs(a - b) for a, b in zip(costs, w["costs"])
          if a is not None and b is not None]
    return {f"{name}_same_words": int(sum(same)),
            f"{name}_differ": [b for b, ok in enumerate(same) if not ok],
            f"{name}_max_cost_diff": max(dc, default=0.0)}


def witness(w: dict) -> dict:
    """JAX's (and the port's, on the CPU) decode of the recorded batch ->
    the utterances with the card's words, the largest cost differences
    and each side's overflow."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder as TCsr
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts as TOpts
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph as TPacked
    ll, nf = _batch(w)
    jdec = JCsr(JPackedGraph(**w["graph"]), JOpts(**w["opts"]))
    out = {"utterances": len(nf),
           "card_overflow": int(np.sum(w["overflow"]))}
    out.update(_compare("jax", jdec.decode(ll, nf), w))
    out["jax_overflow"] = int(np.sum(np.asarray(jdec.last_overflow)))
    tdec = TCsr(TPacked(**w["graph"]), TOpts(**w["opts"]), device="cpu")
    out.update(_compare("port_cpu", tdec.decode(ll, nf), w))
    out["port_cpu_overflow"] = int(np.sum(tdec.last_overflow))
    return out


def test_csr_witness_replays_a_cpu_decode_through_jax():
    """A yesno decode on the CPU recorded as phase 20 records the card's,
    replayed through JAX's CsrBeamDecoder: every utterance JAX's words,
    costs within 1e-4 of their magnitude, the overflow JAX's."""
    import chip_smoke as cs
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    ys = cs.yesno_gmm_system()
    feats = [cs.mfcc_deltas(wv, "cpu") for wv in ys["waves"]]
    fb, nf = cs.pad_batch(feats)
    ll = ys["model"].am.loglikes(fb)
    opts = CsrBeamOpts(**cs.LADDER_DECODE)
    dec = CsrBeamDecoder(ys["packed"], opts, device="cpu")
    res = dec.decode(ll, nf)
    w = pickle.loads(pickle.dumps(cs.csr_witness_data(
        ys["packed"], ll, nf, opts, res, dec.last_overflow), protocol=4))
    assert w["opts"] == dataclasses.asdict(opts) and all(w["words"])
    out = witness(w)
    n = out["utterances"]
    assert n == 3 and out["jax_same_words"] == n
    assert out["port_cpu_same_words"] == n
    assert out["jax_max_cost_diff"] <= 1e-4 * max(
        abs(c) for c in w["costs"])
    assert out["jax_overflow"] == out["card_overflow"]


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[1], "rb") as f:
        print(json.dumps(witness(pickle.load(f)), indent=1))
