"""The sharded-server session of tests/test_torch_parallel_serving.py,
shared by the test (JAX's server) and its gloo ranks (the port's). It
imports the port only: the ranks run without jax."""

import numpy as np

# test_torch_serving.py's setup
GRAPH = dict(vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3)
TDNN = dict(feat_dim=24, num_pdfs=16, hidden_dim=64, pnorm_output_dim=32,
            nonlinearity="relu",
            splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
DECODE = dict(beam=11.0, max_active=128, acoustic_scale=0.1,
              expand_budget=2048, eps_budget=512, hub_threshold=64)
SERVE = dict(n_streams=8, chunk_samples=2560, t_max=256, keep_loglikes=True)
LATTICE_SLOTS = (1, 6)              # one on each rank's device


def waves(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(L)).astype(np.float32) * 4000
            for L in rng.integers(8000, 16000, size=n)]


def port_parts(device="cpu"):
    """The port's AM (numpy-seeded weights, non-uniform priors), decoder
    and fbank options."""
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.ops.features import FbankOpts
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.params import random_tdnn_params
    params = random_tdnn_params(TdnnConfig(**TDNN), np.random.default_rng(0))
    priors = np.random.default_rng(1).dirichlet(np.ones(16))
    am = AmNnet(Tdnn(TdnnConfig(**TDNN)).load_jax_params(params),
                priors=priors)
    graph, _ = make_big_hclg(BigGraphConfig(**GRAPH))
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**DECODE), device=device)
    fb = FbankOpts(frame_opts=FrameOpts(dither=0.0),
                   mel_opts=MelOpts(num_bins=24))
    return am, dec, fb


def session(srv, waves, more):
    """Open 8 slots, feed every wave whole, drain, take the best paths and
    two lattices; then close slots 0 and 7 (one per rank), reopen two
    slots, and decode `more` in them fed in two parts."""
    slots = [srv.open() for _ in waves]
    assert srv.open() is None          # batch is full
    for s, w in zip(slots, waves):
        srv.feed(s, w)
        srv.input_finished(s)
    for s in slots:
        srv.drain(s)
    best = [srv.best_path(s) for s in slots]
    lats = [srv.get_lattice(slots[i], 6.0) for i in LATTICE_SLOTS]
    for i in (0, 7):
        srv.close(slots[i])
    reopened = [srv.open(), srv.open()]
    for s, w in zip(reopened, more):
        srv.feed(s, w[:5000])
    srv.step()
    for s, w in zip(reopened, more):
        srv.feed(s, w[5000:])
        srv.input_finished(s)
    for s in reopened:
        srv.drain(s)
    again = [srv.best_path(s) for s in reopened]
    return dict(slots=slots, reopened=reopened, best=best, again=again,
                lats=[None if lat is None
                      else {(w, t): c for (w, t, c)
                            in lat.paths(max_paths=100000)}
                      for lat in lats])
