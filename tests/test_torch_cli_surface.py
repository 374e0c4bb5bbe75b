"""The port's CLI surface against JAX's: tests/test_cli_surface.py's
argparse probe (it needs no /root/reference) run on `kaldi_tpu.cli.main`
and `kaldi_tpu_torch.cli.main`. The port's subcommands and aliases are a
subset of JAX's, and what the port still lacks is exactly the list below
(456 subcommands and JAX's 80 `_ALIASES`); each CLI slice that ports
subcommands takes them off it.
"""

import argparse
import importlib

NOT_YET_PORTED = set("""
acc-lda acc-tree-stats add-deltas add-deltas-sdc add-self-loops ali-to-pdf
ali-to-phones ali-to-post align-compiled-mapped align-equal
align-equal-compiled align-mapped align-text am-info analyze-counts
append-feats append-vector-to-feats apply-cmvn apply-cmvn-online
apply-cmvn-sliding arpa-to-const-arpa arpa2fst build-pfile-from-ali
build-tree build-tree-two-level cluster-phones cmvn-to-nnet compare-feats
compile-questions compile-train-graphs compile-train-graphs-fsts
compose-transforms compute-and-process-kaldi-pitch-feats compute-atwv
compute-cmvn-stats compute-cmvn-stats-two-channel compute-eer
compute-fbank-feats compute-kaldi-pitch-feats compute-mce-scale
compute-mfcc-feats compute-pitch-feats compute-plp-feats
compute-spectrogram-feats compute-vad compute-wer convert-ali copy-feats
copy-feats-to-htk copy-feats-to-sphinx copy-gselect copy-int-vector
copy-int-vector-vector copy-matrix copy-post copy-transition-model copy-tree
copy-vector create-split-from-vad cuda-compiled cuda-gpu-available
decode-faster decode-faster-mapped decode-fmllr detect-sinusoids dot-weights
draw-tree duplicate-matrix est-lda est-mllt est-pca extend-transform-dim
extend-wav-with-silence extract-ctx extract-feature-segments extract-rows
extract-segments feat-to-dim feat-to-len feat-to-post fgmm-global-acc-stats
fgmm-global-acc-stats-post fgmm-global-acc-stats-twofeats fgmm-global-copy
fgmm-global-est fgmm-global-get-frame-likes fgmm-global-gselect-to-post
fgmm-global-info fgmm-global-init-from-accs fgmm-global-merge
fgmm-global-mixdown fgmm-global-sum-accs fgmm-global-to-gmm fgmm-gselect
fmpe-acc-stats fmpe-apply-transform fmpe-copy fmpe-est fmpe-init
fmpe-sum-accs fst-arcsort fst-compose fst-compose-context fst-connect
fst-determinize-star fst-info fst-invert fst-minimize-encoded fst-pack-graph
fst-phi-compose fst-project fst-push-special fst-rmepsilon fst-rmepslocal
fst-rmsymbols fst-shortest-path fstaddselfloops fstaddsubsequentialloop
fstcomposecontext fstcopy fstdeterminizelog fstdeterminizestar fstfactor
fstisstochastic fstmakecontextfst fstmakecontextsyms fstminimizeencoded
fstphicompose fstpropfinal fstpushspecial fstrand fstrhocompose
fstrmepslocal fstrmsymbols fsts-to-transcripts fsttablecompose
generate-proxy-keywords get-full-lda-mat get-post-on-ali get-silence-probs
gmm-acc-hlda gmm-acc-mllt gmm-acc-mllt-global gmm-acc-stats
gmm-acc-stats-ali gmm-acc-stats-twofeats gmm-acc-stats2 gmm-adapt-map
gmm-align gmm-align-compiled gmm-basis-fmllr-accs gmm-basis-fmllr-accs-gpost
gmm-basis-fmllr-training gmm-boost-silence gmm-compute-likes gmm-copy
gmm-decode-biglm-faster gmm-decode-faster gmm-decode-faster-regtree-fmllr
gmm-decode-faster-regtree-mllr gmm-decode-nbest gmm-decode-simple
gmm-diff-accs gmm-est gmm-est-basis-fmllr gmm-est-basis-fmllr-gpost
gmm-est-fmllr gmm-est-fmllr-global gmm-est-fmllr-gpost gmm-est-gaussians-ebw
gmm-est-hlda gmm-est-lvtln-trans gmm-est-map gmm-est-regtree-fmllr
gmm-est-regtree-fmllr-ali gmm-est-regtree-mllr gmm-est-rescale
gmm-est-weights-ebw gmm-fmpe-acc-stats gmm-get-feat-deriv
gmm-get-stats-deriv gmm-global-acc-stats gmm-global-acc-stats-post
gmm-global-acc-stats-twofeats gmm-global-copy gmm-global-est
gmm-global-est-fmllr gmm-global-est-lvtln-trans gmm-global-get-frame-likes
gmm-global-get-post gmm-global-gselect-to-post gmm-global-info
gmm-global-sum-accs gmm-global-to-fgmm gmm-gselect gmm-info gmm-init-lvtln
gmm-init-model gmm-init-model-flat gmm-init-mono gmm-init-trans
gmm-ismooth-stats gmm-latgen-biglm-faster gmm-latgen-faster
gmm-latgen-faster-parallel gmm-latgen-faster-regtree-fmllr gmm-latgen-map
gmm-latgen-simple gmm-latgen-tracking gmm-make-regtree gmm-mixup
gmm-post-to-gpost gmm-rescore-lattice gmm-scale-accs gmm-sum-accs
gmm-train-lvtln-special gmm-transform-means gmm-transform-means-global
hmm-info info init-ubm interpolate-pitch ivector-adapt-plda
ivector-compute-dot-products ivector-compute-lda ivector-compute-plda
ivector-copy-plda ivector-extract ivector-extract-online
ivector-extract-online2 ivector-extractor-acc-stats ivector-extractor-est
ivector-extractor-init ivector-extractor-sum-accs ivector-mean
ivector-normalize-length ivector-plda-scoring ivector-randomize
ivector-subtract-global-mean ivector-transform kws-index-union kws-search
latgen-faster-mapped latgen-faster-mapped-parallel latgen-tracking-mapped
lattice-1best lattice-add-penalty lattice-add-trans-probs
lattice-align-phones lattice-align-words lattice-align-words-lexicon
lattice-arcgraph lattice-best-path lattice-boost-ali lattice-combine
lattice-compose lattice-confidence lattice-copy lattice-copy-backoff
lattice-depth lattice-depth-per-frame lattice-determinize
lattice-determinize-phone-pruned lattice-determinize-phone-pruned-parallel
lattice-determinize-pruned lattice-determinize-pruned-parallel
lattice-difference lattice-equivalent lattice-expand-ngram lattice-interp
lattice-limit-depth lattice-lmrescore lattice-lmrescore-const-arpa
lattice-mbr-decode lattice-minimize lattice-oracle lattice-project
lattice-prune lattice-push lattice-rescore-mapped lattice-reverse
lattice-rmali lattice-scale lattice-to-ctm-conf lattice-to-fst
lattice-to-kws-index lattice-to-mpe-post lattice-to-nbest
lattice-to-phone-lattice lattice-to-post lattice-to-smbr-post lattice-union
lattice-word-align linear-to-nbest logistic-regression-copy
logistic-regression-eval logistic-regression-train logprob-to-post
make-h-transducer make-ilabel-transducer make-pdf-to-tid-transducer
matrix-dim matrix-logprob matrix-sum matrix-sum-rows mkgraph
modify-cmvn-stats nbest-to-ctm nbest-to-lattice nbest-to-linear
nbest-to-prons nnet-adjust-priors nnet-align-compiled nnet-am-average
nnet-am-combine nnet-am-compute nnet-am-copy nnet-am-fix nnet-am-info
nnet-am-init nnet-am-limit-rank nnet-am-limit-rank-final nnet-am-mixup
nnet-am-reinitialize nnet-am-rescale nnet-am-shrink nnet-am-stats
nnet-am-switch-preconditioning nnet-am-widen nnet-combine nnet-combine-a
nnet-combine-egs-discriminative nnet-combine-fast
nnet-compare-hash-discriminative nnet-compute nnet-compute-from-egs
nnet-compute-prob nnet-concat nnet-copy nnet-copy-egs
nnet-copy-egs-discriminative nnet-forward nnet-get-egs
nnet-get-egs-discriminative nnet-get-feature-transform
nnet-get-feature-transform-multi nnet-get-weighted-egs nnet-gradient
nnet-info nnet-init nnet-initialize nnet-insert nnet-kl-hmm-acc
nnet-kl-hmm-mat-to-component nnet-kl-hmm-sum-accs nnet-latgen-faster
nnet-latgen-faster-parallel nnet-limit-degradation nnet-logprob
nnet-logprob-parallel nnet-logprob2 nnet-logprob2-parallel
nnet-modify-learning-rates nnet-normalize-stddev nnet-perturb-egs
nnet-perturb-egs-fmllr nnet-relabel-egs nnet-replace-last-layers
nnet-select-egs nnet-show-progress nnet-shrink nnet-shuffle-egs
nnet-shuffle-egs-discriminative nnet-subset-egs nnet-to-raw-nnet
nnet-train-blstm-streams nnet-train-discriminative-parallel
nnet-train-discriminative-simple nnet-train-ensemble nnet-train-frmshuff
nnet-train-lstm-streams nnet-train-mmi-sequential nnet-train-mpe-sequential
nnet-train-parallel nnet-train-parallel-perturbed nnet-train-perutt
nnet-train-simple nnet-train-simple-perturbed nnet-train-transitions
nnet1-to-raw-nnet nnet2-boost-silence nnet3-acc-lda-stats
nnet3-am-adjust-priors nnet3-am-copy nnet3-am-info nnet3-am-init
nnet3-am-train-transitions nnet3-average nnet3-combine nnet3-compute
nnet3-compute-from-egs nnet3-compute-prob nnet3-copy nnet3-copy-egs
nnet3-get-egs nnet3-info nnet3-init nnet3-latgen-faster nnet3-merge-egs
nnet3-show-progress nnet3-shuffle-egs nnet3-subset-egs nnet3-train
online-gmm-decode-faster online-wav-gmm-decode-faster
online2-wav-dump-features online2-wav-gmm-latgen-faster
online2-wav-nnet2-latgen-faster paste-feats paste-post pdf-to-counts
phones-to-prons post-to-pdf-post post-to-phone-post post-to-tacc
post-to-weights prob-to-post process-kaldi-pitch-feats process-pitch-feats
prons-to-wordali rand-prune-post raw-nnet-concat raw-nnet-copy raw-nnet-info
rbm-convert-to-nnet rbm-train-cd1-frmshuff recipe-yesno-files remove-mean
reverse-feats reverse-weights scale-post select-feats select-voiced-frames
sgmm-acc-fmllrbasis-ali sgmm-acc-stats sgmm-acc-stats-ali
sgmm-acc-stats-gpost sgmm-acc-stats2 sgmm-acc-tree-stats sgmm-align-compiled
sgmm-build-tree sgmm-calc-distances sgmm-cluster-phones sgmm-comp-prexform
sgmm-copy sgmm-decode-faster sgmm-est sgmm-est-ebw sgmm-est-fmllr
sgmm-est-fmllr-gpost sgmm-est-fmllrbasis sgmm-est-multi sgmm-est-spkvecs
sgmm-est-spkvecs-gpost sgmm-gselect sgmm-info sgmm-init
sgmm-init-from-tree-stats sgmm-latgen-faster sgmm-latgen-simple sgmm-mixup
sgmm-normalize sgmm-post-to-gpost sgmm-rescore-lattice sgmm-sum-accs
sgmm-sum-tree-stats sgmm-write-ubm sgmm2-acc-stats sgmm2-acc-stats-gpost
sgmm2-acc-stats2 sgmm2-align sgmm2-align-compiled sgmm2-comp-prexform
sgmm2-copy sgmm2-est sgmm2-est-ebw sgmm2-est-fmllr sgmm2-est-fmllr-gpost
sgmm2-est-spkvecs sgmm2-est-spkvecs-gpost sgmm2-gselect sgmm2-info
sgmm2-init sgmm2-latgen-faster sgmm2-latgen-faster-parallel
sgmm2-post-to-gpost sgmm2-project sgmm2-rescore-lattice sgmm2-sum-accs
shift-feats show-alignments show-transitions splice-feats split-scp
subsample-feats subset-feats sum-lda-accs sum-matrices sum-mllt-accs
sum-post sum-tree-stats thresh-post train-deltas train-ivector-extractor
train-lda-mllt train-mono train-nnet3 train-plda train-sat train-sgmm2
train-tdnn train-transitions train-ubm transcripts-to-fsts transf-to-nnet
transform-feats transform-vec tree-info utt2spk-to-spk2utt vector-scale
vector-sum wav-copy wav-reverberate wav-to-duration weight-post
weight-silence-post
""".split())


def _commands(module: str) -> tuple[set, set]:
    """-> (subcommands, aliases) that `module`.main registers."""
    cli = importlib.import_module(module)
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        captured["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = spy
    try:
        cli.main(["__probe__"])
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in captured["p"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return set(sub.choices.keys()), set(getattr(cli, "_ALIASES", {}))


def test_port_cli_is_a_subset_of_jax_and_the_rest_is_listed():
    js, ja = _commands("kaldi_tpu.cli")
    ts, ta = _commands("kaldi_tpu_torch.cli")
    assert ts <= js and ta <= ja, sorted((ts - js) | (ta - ja))
    assert (js | ja) - (ts | ta) == NOT_YET_PORTED
    assert len(NOT_YET_PORTED & js) == 456 and len(NOT_YET_PORTED & ja) == 80
