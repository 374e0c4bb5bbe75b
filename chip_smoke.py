#!/usr/bin/env python3
"""Run the PyTorch port's serving, training, GMM-HMM, discriminative
training, nnet3 / nnet1, speaker-recognition, adaptation and SGMM2,
rescoring and keyword-search paths, its pitch, resampling and
reverberation features and its file-driven CLI once on one CUDA card and
check them.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile every kernel in kaldi_tpu_torch/csrc (one nvcc each,
     all at once) and print ptxas' registers / spills;
  3. table-gather kernel vs plain: bit-exact against torch.gather at the
     decoder's shapes and at the edges, with CUDA-graph timings beside an
     empty kernel at the same grid (the launch floor);
  4. qaffine kernel vs plain (`qaffine_ref`) at the int8 TDNN's shapes and
     at the edges; both against an f64 product, and the kernel at small K
     held to a limit that a kernel without the lo pass of x fails; timings
     of the kernel, the plain version and torch.addmm over pre-dequantized
     weights; its bound is 2MNK on the bf16 tensor cores or its bytes,
     printed beside the design's three-pass ceiling and the FP32-FMA bound;
  5. decoder on the card vs the same port on the CPU, on small graphs:
     identical words, tids and counters, cost within 1e-2;
  6. int8 decode on the card vs on the CPU (small QuantizedTdnn behind
     `Recognizer`): identical words and tids, cost within 1e-2;
  7. full-width slice: the 60k-word / 1.05M-state HCLG and the 2048-pdf
     relu TDNN (random weights from a seed) behind `Recognizer`, answering
     three requests of 8 x 10 s utterances in bf16 at beam 13,
     max_active 7000, expand_budget 16384, then one request split by
     layer; --profile adds one decode under torch.profiler (device busy
     share and the kernels that take the device time);
  8. full-width int8 slice: the same graph and corpus behind
     `Recognizer(QuantizedTdnn)`, three requests, 6 qaffine launches each,
     then bf16 and int8 requests in turns;
  9. streaming, small: `FusedStreamingServer` on the card vs on the CPU,
     and each stream vs the offline decode on the card;
 10. streaming, full width: 16 streams of 10 s fed 160 ms per step into
     the server over the 60k-word HCLG and the 2048-pdf f32 TDNN behind
     `AmNnet`; every stream equals its offline decode on the card;
     --profile adds six steady steps under torch.profiler;
 11. lattice path, small: `decode_raw` on the small graphs in dense, f16
     and flat modes (and with init rounds) on the card equals the CPU;
     native lattices equal numpy ones; chunked equals one-shot and
     adaptive equals full on the card; a keep-loglikes server's
     `get_lattice` equals the offline lattice on the card;
 12. training, small, at the CPU tests' shapes: 8 f32 and 8 bf16 steps
     of `make_train_step` over `make_optimizer` with clip, l2 and
     momentum on, 12 `ng_sgd` steps across a refresh, `train_progressive`
     through its three stages, each on the card against the same on the
     CPU (limits in TRAIN_LIMITS), and a checkpoint of card params read
     back equal;
 13. training, full width: the bench's AM (the relu TDNN above) trained
     on the bench's corpus (16 x 10 s, full batch, bf16) with the port's
     `make_optimizer` and `make_train_step` for 400 steps, as bench.py
     trains it, then 10 steps between CUDA events: ms/step, frames/s,
     TFLOP/s and train_mfu by the bench's count (6 x GEMM weights x output
     frames), peak memory, final loss and frame accuracy; 20 `ng_sgd`
     steps (two refreshes) and one f32 step at the same width; --profile
     adds three train steps under torch.profiler;
 14. lattice path, full width, at the bench's latgen point (max_active
     7000, beam 13, expand_budget 16384, eps_budget 2048, rec_cap 3072,
     rec_beam = lattice_beam = 8, rec_f16, rec_flat, rec_flat_cap 512),
     on the bench's 8 test utterances with phase 13's AM:
     `decode_to_lattices_stream` over 2 batches of 8 x 10 s on 8
     extraction threads, once, then one batch split into record decode,
     copy and extraction; the rec_trunc share of shipped slots must stay
     under 5%; untruncated records, whose excess over rec_cap must be
     rec_trunc exactly; records with nothing masked, whose lattice best
     paths equal the bf16 `Recognizer`'s words; one adaptive decode
     (small_max_active 1024) against one full decode;
 15. online path, small: mfcc, plp and deltas, the padded
     `BeamSearchDecoder`, both `FusedOnlineDecoder` engines (each stream
     also against the offline decode on the card) and
     `SingleUtteranceNnet2Decoder` with online i-vectors, each on the card
     against the CPU; the mixed-up AM's group sum: two card runs
     bit-equal, the card within 1e-6 relative of the CPU;
 16. online path, full width, at scripts/bench_streaming.py's
     configuration (the 300-word HCLG, a relu TDNN of width 512 over 64
     pdfs trained 300 bf16 steps on the card, 160 ms chunks): the fused
     path (`FusedOnlineDecoder` on the CSR engine, with `get_lattice` on
     the first 2) over 6 utterances and the generic path
     (`SingleUtteranceNnet2Decoder` over the padded engine) over 3:
     online RTF, chunk latency p50 / p95,
     finalize and get_lattice ms, max delay, and hypothesis mismatches
     against the offline decode on the card, which must be 0; then the
     gather kernel timed at the fused path's B = 1 shapes;
 17. GMM path, small: `AmDiagGmm.loglikes` on the card vs the CPU;
     `equal_align`, `viterbi_align` and one EM iteration on yesno and
     rm-like training graphs (identical alignments; parameters within
     1e-5, loglikes within 1e-5 of their GEMM terms' magnitude); the
     dense decoder's associative, sequential and checkpointed paths and
     its hub branch (identical words and tids, cost within 1e-4);
     `recipe-yesno` on the card (WER 0);
 18. GMM path, full width: (a) `train_mono` at `MonoTrainOpts()` (40
     iterations, totgauss 1000) on 250 rm-like utterances with MFCC +
     deltas on the card, ms per iteration by phase, then the test WER of
     50 more through `make_decoder` (limit 12.0); (b) bench.py's
     small-graph serving line (yesno HCLG, dense associative path, 128 x
     10 s of noise through phase 13's AM, 8 pipelined launches); (c) the
     same shape of 25-word rm-like utterances through the rm-like HCLG's
     sequential path from (a)'s loglikes; the gather and qaffine must not
     launch; --profile adds one profiled realignment and one launch of
     (b) and of (c);
 19. triphone ladder, small, at tests/test_triphone_e2e.py's and
     test_sat_lda.py's sizes and options, card vs CPU: the tree from card
     and CPU alignments (identical), train_deltas' first EM iteration
     from its init (parameters within 1e-5, loglikes within 1e-5 of their
     GEMM terms' magnitude), train_deltas on the card with its N-phone HCLG by
     make_hclg and make_hclg_flat decoding alike (WER 0); alignments,
     splice and LDA from card and CPU statistics (1e-5); the MLLT and
     fMLLR statistics (per speaker) from the card's and the CPU's
     posteriors on the same alignments, each within the bound that the
     per-gaussian loglikes' difference sets (each posterior by the exact
     softmax response to that difference, plus f32 rounding), the
     loglikes within 1e-5 of their GEMM terms;
     MLLT and fMLLR matrices from each device's statistics reported (host
     f64 solves); train_lda_mllt on the card (WER 0);
     apply_affine_transform (1e-5), train_sat on the card and
     decode_fmllr giving the same words on card and CPU (SAT <= SI < 25);
 20. triphone ladder, full width: tests/test_ladder_full.py's corpus (120
     words over 30 phones, 5 speakers, 200 training and 40 test
     utterances) and options on the card: train_mono -> train_deltas ->
     train_lda_mllt -> train_tdnn, each decoded through make_hclg_flat +
     CsrBeamDecoder (beam 14, max_active 1024, expand_budget 16384), with
     seconds and ms per iteration by phase; PARITY.md's rungs (tri < mono
     - 8, lda <= tri, tdnn <= lda + 1) and bars (35 / 12 / 7 / 7) must
     hold; then train_sat from tri and decode_fmllr, SAT <= SI; both graph
     pipelines timed on tri's HCLG; qaffine must not launch; the gather
     kernel bit-exact against its plain version, and timed, at every
     shape the ladder's decodes gave it; --profile adds one profiled
     realignment and one accumulation pass;
 21. discriminative path, small: tests/test_discriminative.py's yesno
     system with the same (CPU) denominator lattices, boosted once, and
     the same numerator alignment on card and CPU: one MMI and one sMBR
     iteration's num and den statistics, each within the bound that the
     two devices' loglikes set (a path's log-weight moves by at most the
     lattice's spread S of 0.1 x their difference, so a lattice weight by
     gamma (1 - gamma)(e^S - 1), an MPE weight by (e^S - 1) sd(A)
     (sqrt(gamma) + gamma e^S); each gaussian's posterior as in phase
     19); the EBW-updated means and variances from each device's
     statistics reported; one nnet sMBR step of a small TDNN (each leaf
     within 1e-5 of its largest |p| plus its largest step); neither
     kernel may launch;
 22. discriminative path, full width: (a) tests/test_rm_like_recipe.py's
     pyramid on the card (42 training and 12 test utterances at seed 17;
     mono 14 iterations / 140 gaussians, tri 12 / 350 / 120 leaves, bMMI
     2 iterations at boost 0.1) held to PARITY.md:32 (mono <= 12, tri <=
     10, tri <= mono, bMMI <= tri, bMMI <= 8), then fMMI at
     tests/test_fmmi.py's options from that tri and on test_fmmi.py's
     yesno system, finite with a moved projection, each WER against its
     base reported (PARITY.md:34 is not held: JAX's fMMI breaks it on
     both systems, tests/test_torch_fmmi.py);
     (b) on phase 20's models at the ladder's width: bMMI from tri
     (2 iterations, boost 0.1, on tri's unigram HCLG by make_hclg) and
     sMBR of the TDNN (2 epochs over the first 50 training utterances,
     denominator lattices from its own loglikes through make_hclg_flat +
     CsrBeamDecoder, numerator tids from the LDA+MLLT model), each
     objective non-decreasing and
     every value finite; WERs before and after reported; seconds and ms
     per iteration by phase, lattices per second, mean arcs, None counts;
     the gather kernel bit-exact and timed at the shapes of (b)'s decodes;
     --profile adds one profiled bMMI iteration and one sMBR epoch over
     20 egs;
 23. nnet families, small, at the CPU tests' widths, card vs CPU: the
     nnet3 dense (TDNN) and recurrent (LSTM) executors' forwards (1e-5 of
     max |y|) and 8 NG-SGD steps of each, one nnet1 `train_frmshuff`
     pass and 2 `train_lstm_streams` chunks (TRAIN_LIMITS), a CD-1 update
     from a shared hidden sample (1e-5) and one nnet3 sMBR step on phase
     21's shared lattices (1e-5 of its terms); neither kernel may launch;
 24. nnet families at the ladder's width on phase 20's models, decoded
     through make_hclg_flat + CsrBeamDecoder on the LDA+MLLT HCLG: (a)
     `train_tdnn3` at the nnet2 rung's width (30-dim LDA features, p-norm
     512 -> 128, splices (-2..2), (-1, 2), (0,), NG-SGD at phase 20's
     rates) held to the nnet2 bars (<= 7.0, <= lda_mllt + 1.0); (b)
     `train_lstm3` at its own width, its WER reported, then an LSTM at
     Kaldi's nnet3 LSTM recipe width (cell 1024, projection 256, 3
     layers, chunk 20): its forward over 8 test utterances and 4 NG-SGD
     steps card vs CPU, ms per step, frames/s and the card's idle share;
     (c) a DBN (steps/nnet/pretrain_dbn.sh: 6 x 2048 RBMs over splice
     +-5, one CD-1 epoch each) fine-tuned by `train_frmshuff` and decoded
     with alignment-count priors: each RBM's reconstruction error falls,
     the fine-tuning raises the frame accuracy, the WER is reported; the
     gather kernel bit-exact and timed at these decodes' shapes; qaffine
     must not launch; --profile prints the wide LSTM's profiled step by
     kernel;
 25. speaker recognition, small, card vs CPU: tests/test_sre_pipeline.py's
     corpus through sre10 v1 (GMM-UBM, 8 gaussians) and v2 (its oracle
     posteriors over 4 classes), 8-dim i-vectors, on each device (the
     EERs equal and under PARITY.md:47's 15%), then each stage from the
     same inputs within the bound its arithmetic sets, every ratio to its
     bound logged: the diag and the full UBM's statistics (the f32
     loglikes' difference through the softmax), the gselect / min-post
     stats (a frame may change its selection only where its loglikes'
     difference could reorder its top k; such frames counted), one
     extractor E-step for v1 and v2 (L and b to their f64 rounding, w and
     L^-1 to kappa(L) times the measured differences and residuals), the
     M-step's statistics A and B (what the E-step's differences carry
     into them), and each side's solves (L w = b, L L^-1 = I, the
     M-step) by their backward error, SOLVE_C (K + D) eps64; logistic regression (the loss within 1e-4, the same classes);
     the VAD of sre10's MFCCs from the card and the CPU (a decision may
     differ only within the features' difference of the threshold);
     neither kernel may launch;
 26. speaker recognition at egs/sre10's width on the card: `sre_corpus`
     (ladder_synth speech at 8 kHz, 200 speakers with their own warp and
     tilt, 6 training, 1 enrollment and 1 test utterance each; 40,000
     trials) with sre10's MFCCs (20 cepstra, 20-3700 Hz, 25 ms, + deltas
     = 60 dims) on the card; (a) v1 with VAD, a 2048-gaussian full UBM and
     a 600-dim extractor; (b) v2 without VAD, its posteriors phase 20's
     TDNN over the LDA+MLLT model's pdfs; each with seconds by stage and
     per EM iteration, peak memory, the full UBM's log-likelihood per
     iteration and the EERs by PLDA and by cosine scoring (reported), and
     held: (i) the stages for 4 utterances recomputed on the CPU within
     phase 25's bounds (the M-step over 64 gaussians), (ii) the UBM
     log-likelihood never falling by more than 1e-6 relative, (iii) every
     tensor finite; (c) logistic regression over (a)'s training i-vectors
     at the reference's options (final loss and closed-set accuracy
     reported); neither kernel may launch;
 27. adaptation and SGMM2, small, card vs CPU, every ratio to its bound
     logged: tests/test_sgmm.py's sgmm_setup (4 gaussians, 3 states split
     to 6 substates, a speaker vector): `loglikes_matrix` (f64 rounding of
     its terms), the accumulation's gamma, y, Y, Q, S_centered and total
     loglike (the exact softmax response to the measured loglike
     difference times each term, plus f64 GEMM rounding; gselect compared
     as sets, flips counted), each update flag of vMwSc by its backward
     error (v's and M's solves, Sigma's inverse) or its terms (w, c), the
     EBW v, w and M quadratic solves by their backward error against the
     floored Q, SGMM fMLLR (statistics 1e-9 of their terms, one gradient
     1e-9, the line search by its auxiliary), gpost, the pre-transform,
     the fMLLR basis and state distances; tests/test_adaptation_extras.py's
     inputs through MLLR, the regression tree (statistics within the
     posteriors' bound), basis fMLLR (one gradient 1e-9, the ascent by its
     auxiliary), LVTLN (solves by backward error, the same class) and HLDA;
     tests/test_fmllr_raw.py's through raw fMLLR (one Adam step 1e-5, the
     150-step run by its objective 1e-3); then test_sgmm.py's two yesno SGMM
     runs on each device, held to PARITY.md:36 (RandomState 13) and :37
     (21, bMMI); neither kernel may launch;
 28. adaptation and SGMM2 on phase 20's models at the ladder's width,
     each decode through make_hclg_flat + CsrBeamDecoder: (a) the LDA+MLLT
     model adapted per test speaker by global fMLLR, raw fMLLR (13-dim MFCC
     spliced +-3, the objective's quadratic and log-det shares and the
     square LDA's rejected rows' variance before and after; its
     accumulators saved to chiprun_out/raw_fmllr_witness.pkl for
     tests/test_torch_raw_witness.py), basis fMLLR (a 100-element basis
     from the 200 training utterances, transforms per test utterance),
     regression-tree fMLLR and MLLR, WER and seconds each; (b) LVTLN on the
     tri model (13 classes, warps 0.88-1.12, features through the mel
     banks' VTLN warp), the selected warp per speaker against its true
     warp, WER with and without; (c) HLDA 91 -> 30 dims with tri's pdfs as
     classes; (d) SGMM2 at egs/rm's sgmm2_4a widths (400 gaussians, phase
     dim 31, gselect 15, 3 substates per pdf; 8 iterations, speaker
     subspace off) trained from the LDA+MLLT model over the 48,981
     training frames, one bMMI iteration over its unigram HCLG, SGMM
     fMLLR per test
     speaker: seconds per stage and iteration, loglike per iteration, the
     MMI objectives, peak memory and WERs; the ML iteration whose update
     lowered the loglike most saved to chiprun_out/sgmm_witness.pkl for
     tests/test_torch_sgmm_witness.py; qaffine may not launch; the gather
     kernel bit-exact and timed at these decodes' shapes;
 29. rescoring, search and features, small, card vs CPU: `step_batch` and
     `final_cost_batch` on the three LM shapes of ARPA_SHAPES over 20,000
     seeded queries (word ids past the column domain among them) equal
     the CPU and the scalar `step` exactly; the batch rescorer's lattices
     of the 40-word hub graph's decodes and of random topological
     lattices equal the CPU's array for array at three LM scales;
     `decode_biglm` with its padded decoder on the card against
     `decode_biglm_exact` at tests/test_ubm_biglm.py:92's setup (the same
     words, cost within 1e-3); tests/test_signal_pitch.py's signals
     through the convolution, both resamplers and the NCCF, each within
     the bound of its arithmetic (the ratio logged), and the pitch
     Viterbi path equal on every frame; neither kernel may launch;
 30. rescoring and search at width: (a) bench.py:452-544: its trigram
     (synth_trigram_arpa over 60,000 words, 1,130,773 n-grams) as a
     ConstArpaLm with its tables on the card, rescoring phase 14's latgen
     lattices at lm_scale 0.5 on the card and on the CPU (equal lattices;
     audio-sec/s, BFS levels, host syncs, arcs, table bytes, peak
     memory), then the truncation audit against phase 14's untruncated
     lattices (oracle WERs, top-50 path recall, rescored best-path
     drift); (b) the ladder's 40 test utterances through phase 20's
     LDA+MLLT and TDNN models (make_hclg_flat + CsrBeamDecoder lattices):
     the old G out and the same unigram in (best paths unchanged up to
     the LMs' f32 rounding), a trigram over its 120 words and the oracle
     (held <= the best path) on both, the score_lattices sweep and MBR on
     the LDA+MLLT lattices, a ctm
     through word_align_lattice, KWS over every word and 40 seeded
     phrases against the forced alignment's ctm (ATWV; one-word
     posteriors within 1e-9 of the forward-backward), and decode_biglm
     with the padded decoder on the card; (c) the bench's 8 x 10 s test
     waves through compute_kaldi_pitch + process_pitch, reverberate
     (4800-tap RIR, 15 dB) and resample_waveform (16 -> 8 kHz) on the
     card and the CPU, ms per utterance, card vs CPU within the bounds;
     qaffine may not launch, the gather's launches (b's decodes) counted;
 31. the file layer and network serving, small, card vs CPU: every model
     file kind of io/model_io.py saved by the port, loaded on the card
     and on the CPU and saved again (the same bytes, bit-equal arrays,
     the card's loads computing exactly what the originals did); binary,
     text and compressed arks through the native and the Python readers;
     `DecodeSession` (a yesno GMM) and `FusedDecodeSession` (the small
     CSR setup) fed even, odd and one-byte-first PCM chunks, every
     partial and final equal on the card and the CPU; the threaded
     decoder equal to the synchronous one; `SingleUtteranceGmmDecoder`
     with early fMLLR, the same words and re-estimations, its statistics
     within the bound the two devices' posteriors set; the codecs;
 32. network serving at phase 16's configuration: (a) its AM and HCLG
     through the port's files into build/serving/, loaded on the
     card bit-equal; (b) `AudioServer` with `fused_session_factory` (one
     CsrBeamDecoder and FusedOnlineDecoder per connection) answering 6
     concurrent clients (`stream_wave`, 2560 samples per send): every
     FINAL equals phase 16's offline CSR decode, the gather launches and
     qaffine does not; per-connection wall, FINAL latency after the
     client's SHUT_WR p50 / p95, partials, aggregate audio-sec/s, the
     gather at the server's shape; (c) the same streams through µ-law and
     ADPCM transport (WER against the uncompressed FINALs, reported); (d)
     `ThreadedSingleUtteranceDecoder` over phase 16's generic path equal
     to its synchronous results; (e) `SingleUtteranceGmmDecoder` over
     phase 20's tri on the first 8 of the ladder's test utterances
     through `OnlineFeaturePipeline` at the ladder's MFCC options, without
     adaptation equal to the offline decode of the same pipeline's
     features, with the default policy its WER
     (reported); (f) the CLI
     in-process: the GMM server over the tri files with two connections
     and the client (FINALs equal (e)'s), and
     online2-wav-nnet2-am-compute read back by read_ark equal to
     `AmNnet.loglikes_np` on the same features;
 33. the decoder tools and recipe utilities, small, card vs CPU:
     `check_packed_graph` and `check_tier_tables` silent on the card's
     and the CPU's tables of tests/test_csr_beam.py's word-loop graph in
     both tier-B layouts, every corruption raising alike on both;
     `decode_batched` over `CsrBeamDecoder` equal to the per-utterance
     decodes, card == CPU; `simple_decode` equal to the CSR decoder at an
     unpruned beam; `device_trace` naming the gather kernel;
     `AccuProfiler` synchronising; qaffine may not launch;
 34. the decoder tools at the bench graph's width (after phase 14): (a)
     both verifiers over the bench graph and the card's tier tables,
     timed; (b) `decode_batched` with phase 13's AM (bf16 TDNN over fbank
     + CMVN) at bench.py's search options over the 8 test utterances and
     their cuts at 3 s and 6 s (24 in 3 buckets, batch_size 8): equal to
     each utterance decoded alone (B = 1, the same loglikes rows),
     overflow 0; audio-sec/s between CUDA events, padding share, gather
     launches, and the word errors against `Recognizer`'s words (for
     information); (c) the self-built triphone graph at the full tree
     width (the port's copy of scripts/mkgraph_scale.py's `build`, 2,000
     words), verified and decoded card == CPU on seeded loglikes;
 35. the CLI's five slices, small: every case of `CLI_CASES`
     (the first slice's feature, CMVN, table, matrix, vector, wave,
     data-dir and probe subcommands on seeded files; the second's device
     subcommands on a small yesno GMM system: alignments identical, model
     files array for array, accumulators within 1e-5, loglikes within
     1e-5 of their GEMM terms, a full UBM's update within 1e-9,
     train-deltas by its counts; the third's on the same system:
     latgen-faster-mapped's lattices with the same arcs and costs within
     1e-4, gmm-latgen-faster, the biglm pair and decode-fmllr the same
     words, gmm-rescore-lattice's costs within the loglikes' bound; the
     fourth's nnet cases; the fifth's (5a) speaker, logistic-regression,
     LDA+MLLT and online-GMM device cases, `SRE_CLI_CASES`; and its 5b
     adaptation and SGMM2 device cases, `ADAPT_CLI_CASES`: the SGMM2's
     f64 results within 1e-9, fMLLR-type transforms within 2e-3 of
     their largest entry, posterior-fed statistics within 1e-3, the two
     fMLLR bases by their Rayleigh quotients, the decodes by words)
     in-process with the default device
     (the card) and with --device cpu, host files byte-equal and device
     results within their parity tests' bounds; recipe-yesno-files on
     the card and on the CPU, WER 0 on the GMM and the streaming-TDNN
     paths, seconds by stage; decode-faster, gmm-align,
     decode-faster-mapped and online2 card == CPU on the card's files,
     nnet-am-compute within 1e-5, train-nnet3's round trip,
     online2 --fused == the generic pipeline on a delta-free system,
     cuda-compiled and cuda-gpu-available exit 0; qaffine may not launch;
 36. the bench decode through files (after phase 34): bench.py's 8 test
     waves as wav files, compute-fbank-feats (== the port's fbank of
     read_wave's samples), compute-cmvn-stats and apply-cmvn --norm-vars,
     nnet-am-compute with phase 13's AM (save_am_nnet), save_hclg of the
     bench graph and decode-faster-mapped at bench.py's search options
     through make_decoder's CSR decoder, compute-wer: its words equal a
     direct CsrBeamDecoder decode of the same loglikes ark (overflow 0),
     the gather launches about twice a frame (then timed at this decode's
     shapes against its plain version), qaffine does not; each
     command's seconds and audio-sec/s, the HCLG file's size, save and
     load seconds, and the word errors against phase 34's Recognizer-path
     words (for information).
 37. Kaldi's egs/rm/s5 GMM front half through the CLI's files at the
     triphone ladder's width (phase 20's corpus as 8 kHz wav files, 2
     shards): compute-mfcc-feats + add-deltas; train_mono.sh as
     primitives (gmm-init-mono, align-equal, then gmm-boost-silence,
     gmm-align, gmm-acc-stats-ali per shard, gmm-sum-accs, gmm-est with a
     mix-up ramp to 500 gaussians, 14 iterations); train_deltas.sh
     (acc-tree-stats per shard, sum-tree-stats, cluster-phones,
     compile-questions, build-tree at 200 leaves, gmm-init-model,
     convert-ali, 12 iterations to 1,500 gaussians); mkgraph.sh as
     primitives from arpa2fst to fst-pack-graph beside mkgraph;
     decode-faster and compute-wer on the 40 test utterances. Mono and
     tri WER within LADDER_BARS, tri < mono; the shards' sums equal one
     unsharded accumulation (1e-6); one accumulation at width card vs
     --device cpu within 1e-5 plus the bound that the gaussian loglikes'
     difference sets; the primitive graph decodes to mkgraph's
     words (its states logged beside mkgraph's: the text FSTs round
     weights to 7 digits); seconds by stage and command kind, file
     sizes; neither kernel launches (the dense decoder).
 38. Kaldi's egs/rm/s5 decode and scoring back half through the CLI's
     files, on phase 37's tri model, primitive-built HCLG, G.txt and
     test set: decode.sh (gmm-latgen-faster --determinize-lattice);
     score.sh over LM weights 7, 10, 13 and penalties 0, 0.5
     (lattice-scale, lattice-add-penalty, lattice-best-path, compute-wer)
     and lattice-oracle; lmrescore_const_arpa.sh (arpa-to-const-arpa of
     a trigram at LADDER_TRIGRAM's sizes and of the unigram,
     lattice-lmrescore --lm-scale -1, lattice-lmrescore-const-arpa) and
     gmm-latgen-biglm-faster; gmm-compute-likes and latgen-faster-mapped
     into raw lattices; lattice-mbr-decode, lattice-to-ctm-conf,
     lattice-to-post, weight-silence-post, post-to-weights,
     post-to-pdf-post; KWS (lattice-to-kws-index on two shards,
     kws-index-union, kws-search, compute-atwv against a forced
     alignment's references); decode_fmllr.sh (decode-fmllr, 5
     speakers); latgen-faster-mapped card == CPU on 8 utterances;
     gmm-rescore-lattice. Best scored WER within LADDER_BARS' tri bar,
     oracle within it; the identity rescoring keeps every best path and
     gmm-rescore-lattice too (near-ties within their bounds counted);
     the sharded index's hits == the unsharded one's; posteriors sum to 1
     per frame, silence-weighted ones in [0, 1]; neither kernel launches.
 39. Kaldi's nnet2, nnet3 and DBN recipes through the CLI's files on
     phase 37's (`phase_nnet_cli`).
 40. egs/sre10 v1's run.sh through the CLI's files on phase 26's corpus
     (`phase_sre_cli`): features, VAD, the full UBM, the 600-dim
     extractor, i-vectors, PLDA and cosine scoring, the EER, logistic
     regression; PLDA EER <= 15% and below the cosine one, seconds by
     command and stage, file sizes, peak memory; neither kernel launches.
 41. Kaldi's egs/rm/s5 adaptation and SGMM2 chain through the CLI's files
     on phase 37's (`phase_adapt_cli`): train_sat.sh as primitives
     (fMLLR from silence-weighted alignment posteriors, the tree on the
     fMLLR features, EM with realignment and fMLLR re-estimation, the SI
     model by two-feature statistics), mkgraph.sh's primitives,
     decode_fmllr.sh (the SI pass, its lattices' posteriors, the
     speakers' fMLLR, the adapted pass), train_ubm.sh (init-ubm at 400
     gaussians, the gmm-global-* EM), train_sgmm2.sh at phase 28's
     SGMM_WIDTH (sgmm2-init, sgmm2-gselect, sharded sgmm2-acc-stats ->
     sgmm2-sum-accs -> sgmm2-est with the substate split, one
     realignment by sgmm2-align-compiled) and decode_sgmm2.sh
     (sgmm2-latgen-faster, sgmm2-rescore-lattice); SAT <= its SI pass and
     <= LADDER_BARS' tri bar, SGMM2 < 20 (PARITY.md:36; SGMM2 <= SAT + 5
     reported: JAX's updates miss it at width, ROADMAP §3 B 8),
     the shards' sums equal one accumulation, one sgmm2-acc-stats at
     width card == --device cpu within 1e-9, the rescored lattices keep
     their best paths; seconds by stage and command kind, file sizes,
     peak memory, each WER; neither kernel launches.
 42. the multi-device slice (`phase_parallel`, kaldi_tpu_torch/parallel):
     (a) one rank over NCCL, mesh (1, 1): `decode_sharded` over 2 of the
     bench's utterances, `decode_frontier_sharded` on 300 frames of one,
     the sharded server (4 streams x 2 s) and 5 f32 mesh train steps,
     each equal to its single-device run on the card; (b) two ranks on the
     one card over gloo with CUDA tensors (NCCL refuses two ranks on one
     card), spawned by the port's `launch_local` (`PARALLEL_FLAG`; they
     build the graph and decoder during (a), then wait for its end): the
     frontier-sharded decode at D = 2 on 2 of the bench's utterances over
     the 1.05M-state HCLG at beam 13, max_active 7000, expand_budget
     16384, the utterance-sharded decode of the 8 (4 per rank) and 5 f32
     data-parallel steps on phase 13's batch, each against the single
     card (words and tids equal, costs within 1e-2; training held with the
     single card to an f64 run, PARALLEL_F32_FACTOR); gathered bytes and ms per frame, ms per train
     step beside the single-rank figures; qaffine does not launch.

Phases 20, 22 (b), 24 (c), 28 (b) and 41 save the inputs of the recipe
witnesses (chiprun_out/sat_witness.pkl and csr_witness.pkl, then
smbr_witness.pkl, dbn_witness.pkl and lvtln_witness.pkl; with
raw_fmllr_witness.pkl and sgmm_witness.pkl from 28, and
sgmm_cli_witness.pkl from 41, read by test_torch_sgmm_witness.py), which
tests/test_torch_<name>_witness.py replays through JAX on a CPU.

Two processes share the card. Most phases that take nothing from phase
20's ladder run in a second one (the script with --side-phases): the
bench graph's chain (7, 8, 10, 13, 14, 34, 36, 18, 30 a and c), 37, 38,
39, 41, 19, then the small card-vs-CPU phases (5, 6, 9, 11, 12, 15, 17, 21, 23,
25, 27, 29, 31, 33); this one runs 1-4, then 16, 20, 22, 24, 26, 28, 30 b,
32, 40, 35 and 42 beside it, and prints the second's log after phase 35's, with
both processes' ends on its clock. Each phase's start goes to stderr with
the seconds since its process began; a run still going at 1000 s dumps
every thread's stack there.

The line before the last is a JSON object with each kernel's launches on
its path, error against its plain version, times and bound; the last line
is {"ok": true, "device": {...}}. There is no CPU fallback: without CUDA
the script fails.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import socket
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

GATHER_SHAPES = [(8, 2048, 30384),   # fused acoustic lookup, per frame
                 (8, 7000, 4096)]    # frontier-score lookup, per frame
# published H100 SXM peaks (NVIDIA data sheet), at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12             # dense tensor cores

# (M, K, N) of the int8 TDNN's qaffine calls at B = 8, T = 998 (M = 7984),
# with how many of the 6 calls of one request have that shape
QAFFINE_SHAPES = [((7984, 200, 1024), 1), ((7984, 2048, 1024), 3),
                  ((7984, 1024, 1024), 1), ((7984, 1024, 2048), 1)]
QAFFINE_EDGES = [(40, 128, 128),      # tests/test_quantized.py's shape
                 (1, 200, 1024),      # M = 1
                 (37, 72, 48),        # M, K, N all ragged
                 (300, 72, 1024),     # K = 72
                 (130, 1024, 48),     # N = 48
                 (200, 33, 1000),     # K % 4 != 0 (scalar loads), N ragged
                 (129, 256, 130)]     # one row and two columns past a tile
GATHER_EDGES = [(3, 200, 1000),      # P not a multiple of 128
                (2, 4096, 5000),     # widest staged row
                (2, 4097, 3001),     # narrowest direct row, N % 4 != 0
                (2, 16384, 5000),    # wide direct rows
                (2, 20000, 3000),
                (4, 7000, 1),        # N = 1
                (3, 2048, 1001),     # staged, N % 4 != 0
                (1, 2048, 30384)]    # B = 1


def log(*a):
    print(*a, flush=True)


T_START = time.perf_counter()
T_START_WALL = time.time()      # the two processes' ends on one clock
# past this many seconds every thread's stack goes to stderr, so that a run
# stopped at the 1200 s limit shows where it was
STACKS_AFTER_S = 1000
# sockets of phases 31-32: a connection that stalls fails the run instead
# of holding it to the time limit
SOCKET_TIMEOUT_S = 120


# The phases that take nothing from phase 20's ladder (the bench graph's
# chain, 7-14, 18 and 30 a, c, phase 37, which trains its own models from
# LADDER's corpus through the CLI, then these small card-vs-CPU ones) run in a
# second process beside those that do: its stdout in SIDE_LOG (copied to
# this one's at the end), its launch counts in SIDE_RESULTS, its CPU ops
# on SIDE_THREADS threads so that the other's host loops keep their cores.
# Phases 40 and 35 run in this process after phase 32; phase 41 (on
# phase 37's files) and then phase 19 run in the second one after phase
# 39: which keeps the two processes' times within 30 s of each other
SMALL_PHASES = (
    (5, "decoder on the card vs on the CPU", "phase_decoder_parity"),
    (6, "int8 decode on the card vs on the CPU", "phase_int8_parity"),
    (9, "streaming server, small: card vs CPU vs offline",
     "phase_stream_small"),
    (11, "lattice path, small: card vs CPU, native vs numpy",
     "phase_lattice_small"),
    (12, "training, small: card vs CPU", "phase_train_small"),
    (15, "online path, small: card vs CPU vs offline", "phase_online_small"),
    (17, "GMM path, small: card vs CPU", "phase_gmm_small"),
    (21, "discriminative path, small: card vs CPU on shared lattices",
     "phase_disc_small"),
    (23, "nnet3 and nnet1 families, small: card vs CPU", "phase_nnet_small"),
    (25, "speaker recognition, small: sre10 v1 and v2 card vs CPU, each "
         "stage within its bound, logistic regression, VAD",
     "phase_sre_small"),
    (27, "adaptation transforms and SGMM2, small: card vs CPU, each check "
         "within its bound, the yesno SGMM runs at PARITY.md:36-37",
     "phase_adapt_sgmm_small"),
    (29, "rescoring, search and features, small: step_batch, the batch "
         "rescorer, decode_biglm vs its exact oracle, pitch, resampling and "
         "convolution, card vs CPU", "phase_rescore_small"),
    (31, "the file layer and network serving, small: every model file "
         "kind, arks, the decode sessions, the threaded and the online GMM "
         "decoders, card vs CPU", "phase_serving_small"),
    (33, "decoder tools and recipe utilities, small: the graph and tier-"
         "table verifiers, decode_batched, simple_decode, device_trace, "
         "AccuProfiler, card vs CPU", "phase_tools_small"))
SIDE_FLAG = "--side-phases"
SIDE_LOG = os.path.join(ROOT, "chiprun_out", "side_phases.log")
SIDE_RESULTS = os.path.join(ROOT, "chiprun_out", "side_phases.json")
SIDE_THREADS = 3


def log_phase(msg: str):
    """A phase's header on stdout, and its start on stderr in seconds since
    the script began."""
    log(msg)
    print(f"chip_smoke {msg.split(']')[0]}] at "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr,
          flush=True)


def wer(refs: list[list], hyps: list[list]) -> float:
    """Corpus word error rate in percent, by the port's copy of
    utils/wer.py (Levenshtein over words)."""
    from kaldi_tpu_torch.utils.wer import compute_wer
    return compute_wer(dict(enumerate(refs)), dict(enumerate(hyps))).wer


# the GMM path's corpora: tests/test_yesno_e2e.py's yesno tones and
# tests/test_rm_like_recipe.py's 12-word, 20-tone-phone corpus (8 kHz)
GMM_SR = 8000.0
YESNO_LEXICON = "YES Y1 Y2\nNO N1 N2"
YESNO_ARPA = ("\\data\\\nngram 1=4\n\n\\1-grams:\n-1\tNO\n-1\tYES\n"
              "-99\t<s>\n-1\t</s>\n\n\\end\\\n")
YESNO_TONES = {"YES": 440.0, "NO": 1320.0}
RM_PHONE_FREQS = {f"P{i}": 260.0 * (1.13 ** i) for i in range(20)}
RM_WORDS = {
    "ONE": "P0 P5", "TWO": "P1 P6", "THREE": "P2 P7 P12",
    "FOUR": "P3 P8", "FIVE": "P4 P9 P13", "SIX": "P10 P14",
    "SEVEN": "P11 P15 P0", "EIGHT": "P16 P1", "NINE": "P17 P2",
    "ZERO": "P18 P3 P8", "OH": "P19 P4", "STOP": "P5 P10 P15",
}
RM_LEXICON = "\n".join(f"{w} {p}" for w, p in RM_WORDS.items())


def yesno_synth(words, rng) -> np.ndarray:
    """One yesno utterance: a tone per word between silences, light noise
    (tests/test_yesno_e2e.py `synth_utterance`)."""
    sr = GMM_SR
    chunks = [np.zeros(int(sr * rng.uniform(0.08, 0.15)))]
    for w in words:
        dur = rng.uniform(0.25, 0.4)
        t = np.arange(int(sr * dur)) / sr
        freq = YESNO_TONES[w] * rng.uniform(0.98, 1.02)
        tone = np.sin(2 * np.pi * freq * t) * 3000 * rng.uniform(0.7, 1.0)
        env = np.minimum(1.0, np.minimum(
            np.arange(len(t)), len(t) - np.arange(len(t))) / (0.02 * sr))
        chunks.append(tone * env)
        chunks.append(np.zeros(int(sr * rng.uniform(0.1, 0.2))))
    wave = np.concatenate(chunks)
    wave += rng.randn(len(wave)) * 20.0
    return wave.astype(np.float32)


def rm_synth(words, rng) -> np.ndarray:
    """One rm-like utterance: a tone per phone, silences between words,
    noise (tests/test_rm_like_recipe.py `synth`)."""
    sr = GMM_SR
    chunks = [np.zeros(int(sr * rng.uniform(0.05, 0.1)))]
    for w in words:
        for ph in RM_WORDS[w].split():
            dur = rng.uniform(0.09, 0.16)
            t = np.arange(int(sr * dur)) / sr
            f = RM_PHONE_FREQS[ph] * rng.uniform(0.99, 1.01)
            env = np.minimum(1.0, np.minimum(
                np.arange(len(t)), len(t) - np.arange(len(t)))
                / (0.012 * sr))
            chunks.append(np.sin(2 * np.pi * f * t) * 2500
                          * rng.uniform(0.75, 1.0) * env)
        chunks.append(np.zeros(int(sr * rng.uniform(0.06, 0.14))))
    w = np.concatenate(chunks)
    w = w + rng.randn(len(w)) * 60.0
    return w.astype(np.float32)


def rm_corpus(rng, n: int, lo: int = 3, hi: int = 6) -> list:
    """n (words, wave) pairs of lo..hi-1 words drawn as
    tests/test_rm_like_recipe.py draws them."""
    vocab = list(RM_WORDS)
    out = []
    for _ in range(n):
        ws = [vocab[rng.randint(len(vocab))]
              for _ in range(rng.randint(lo, hi))]
        out.append((ws, rm_synth(ws, rng)))
    return out


# tests/test_triphone_e2e.py's corpus: three tone phones shared by four
# two-phone words (real triphone contexts)
TRI_PHONE_FREQS = {"A": 400.0, "B": 900.0, "C": 1800.0}
TRI_LEXICON = "AB A B\nAC A C\nBC B C\nCA C A"
TRI_WORDS = ["AB", "AC", "BC", "CA"]
TRI_ARPA = ("\\data\\\nngram 1=6\n\n\\1-grams:\n-1\tAB\n-1\tAC\n-1\tBC\n"
            "-1\tCA\n-99\t<s>\n-1\t</s>\n\n\\end\\\n")


def tri_synth(words, rng) -> np.ndarray:
    """One utterance of tests/test_triphone_e2e.py's corpus (`synth`): a
    tone per phone, silences between words, light noise."""
    sr = GMM_SR
    chunks = [np.zeros(int(sr * rng.uniform(0.08, 0.12)))]
    for w in words:
        for ph in w:  # one char per phone
            dur = rng.uniform(0.12, 0.2)
            t = np.arange(int(sr * dur)) / sr
            f = TRI_PHONE_FREQS[ph] * rng.uniform(0.98, 1.02)
            tone = np.sin(2 * np.pi * f * t) * 3000 * rng.uniform(0.7, 1.0)
            env = np.minimum(1.0, np.minimum(
                np.arange(len(t)), len(t) - np.arange(len(t))) / (0.015 * sr))
            chunks.append(tone * env)
        chunks.append(np.zeros(int(sr * rng.uniform(0.08, 0.15))))
    wave = np.concatenate(chunks)
    wave += rng.randn(len(wave)) * 20.0
    return wave.astype(np.float32)


def tri_corpus(rng, n: int, featize) -> list:
    """n (utt, featize(wave), words) of tests/test_triphone_e2e.py's
    corpus, drawn as its `corpus` draws them."""
    out = []
    for i in range(n):
        words = [TRI_WORDS[rng.randint(len(TRI_WORDS))]
                 for _ in range(rng.randint(2, 5))]
        out.append((f"u{i}", featize(tri_synth(words, rng)), words))
    return out


# tests/test_ladder_full.py's corpus (tests/ladder_corpus.py with the
# vocabulary of test_ladder_full._mv): coarticulated tones over 30 phones,
# 120 words of 3-5 phones, speakers with fixed frequency warps and
# amplitude tilts, noise
LADDER = dict(seed=19, n_words=120, speakers=5, train_per_spk=40,
              test_per_spk=8, noise=70.0, coart=0.6)


def ladder_vocab(rng, n_words: int, n_phones: int = 30):
    """-> (lexicon text, words): words of 3-5 phones
    (tests/test_ladder_full.py `_mv`)."""
    words = [f"W{k:03d}" for k in range(n_words)]
    lines = []
    for w in words:
        L = int(rng.randint(3, 6))
        seq = " ".join(f"P{rng.randint(n_phones)}" for _ in range(L))
        lines.append(f"{w} {seq}")
    return "\n".join(lines), words


def ladder_synth(phones, freqs, rng, warp, noise, coart, amp_tilt):
    """tests/ladder_corpus.py `synth_utt` over a phone-id sequence: each
    phone a raised-cosine glide between its neighbours' targets."""
    sr = GMM_SR
    targets = np.array([freqs[p] for p in phones]) * warp
    segs = [np.zeros(int(sr * rng.uniform(0.05, 0.1)))]
    n = len(targets)
    for i, f0 in enumerate(targets):
        dur = int(sr * rng.uniform(0.07, 0.14))
        prev_f = targets[i - 1] if i > 0 else f0
        next_f = targets[i + 1] if i + 1 < n else f0
        t = np.arange(dur) / dur
        a = coart / 2
        f_in = 0.5 * (prev_f + f0)
        f_out = 0.5 * (next_f + f0)
        freq = np.where(
            t < a, f_in + (f0 - f_in) * 0.5 * (1 - np.cos(np.pi * t / a)),
            np.where(t > 1 - a,
                     f0 + (f_out - f0) * 0.5 *
                     (1 - np.cos(np.pi * (t - (1 - a)) / a)),
                     f0))
        ph = np.cumsum(2 * np.pi * freq / sr)
        amp = 2200.0 * (1.0 + amp_tilt * (f0 / 3400.0 - 0.5))
        env = np.minimum(1.0, np.minimum(np.arange(dur), dur -
                                         np.arange(dur)) / (0.010 * sr))
        segs.append(np.sin(ph) * amp * env * rng.uniform(0.8, 1.0))
    segs.append(np.zeros(int(sr * rng.uniform(0.05, 0.1))))
    w = np.concatenate(segs)
    return (w + rng.randn(len(w)) * noise).astype(np.float32)


def ladder_corpus(seed: int, n_words: int, speakers: int,
                  train_per_spk: int, test_per_spk: int, noise: float,
                  coart: float, n_phones: int = 30,
                  words_per_utt=(4, 8)) -> dict:
    """tests/ladder_corpus.py `build_corpus(RandomState(seed), ...)` with
    `ladder_vocab`: -> dict(lex_text, words, train, test, warps, tilts),
    the lists of (utt_id, wave, words, spk) and each speaker's frequency
    warp and amplitude tilt."""
    rng = np.random.RandomState(seed)
    lex_text, words = ladder_vocab(rng, n_words, n_phones)
    lexicon = {}
    for line in lex_text.splitlines():
        parts = line.split()
        lexicon[parts[0]] = [int(p[1:]) for p in parts[1:]]
    mel = 1127.0 * np.log1p(np.array([300.0, 3400.0]) / 700.0)
    freqs = 700.0 * np.expm1(np.linspace(mel[0], mel[1], n_phones) / 1127.0)
    warps = {f"s{k}": rng.uniform(0.88, 1.12) for k in range(speakers)}
    tilts = {f"s{k}": rng.uniform(-0.5, 0.5) for k in range(speakers)}

    def gen(spk, n, tag):
        out = []
        for i in range(n):
            ws = [words[rng.randint(n_words)]
                  for _ in range(rng.randint(*words_per_utt))]
            phones = [p for w in ws for p in lexicon[w]]
            wav = ladder_synth(phones, freqs, rng, warps[spk], noise, coart,
                               tilts[spk])
            out.append((f"{tag}_{spk}_{i}", wav, ws, spk))
        return out

    train, test = [], []
    for spk in warps:
        train.extend(gen(spk, train_per_spk, "tr"))
        test.extend(gen(spk, test_per_spk, "te"))
    return dict(lex_text=lex_text, words=words, train=train, test=test,
                warps=warps, tilts=tilts)


def rm_unigram_arpa() -> str:
    """The unigram LM over RM_WORDS of tests/test_rm_like_recipe.py."""
    vocab = list(RM_WORDS)
    lines = [f"-{np.log10(len(vocab)):.4f}\t{w}" for w in vocab]
    return ("\\data\\\nngram 1=%d\n\n\\1-grams:\n%s\n-99\t<s>\n-1\t</s>\n"
            "\n\\end\\\n" % (len(vocab) + 2, "\n".join(lines)))


def _mfcc(waves, device, vtln_warp: float = 1.0):
    """13-dim MFCC of 8 kHz waves ([S] or [B, S]) on `device`, a tensor
    there (the recipes' options: no dither), the mel banks warped by
    vtln_warp."""
    import torch
    from kaldi_tpu_torch.ops.features import MfccOpts, mfcc
    from kaldi_tpu_torch.ops.window import FrameOpts
    fo = MfccOpts(frame_opts=FrameOpts(samp_freq=GMM_SR, dither=0.0))
    return mfcc(torch.as_tensor(waves, device=device), fo,
                vtln_warp=vtln_warp)


def mfcc_deltas(wave, device) -> np.ndarray:
    """39-dim MFCC + delta + delta-delta of one 8 kHz wave on `device`
    (the recipes' features), as a host array."""
    from kaldi_tpu_torch.ops.delta import add_deltas
    return add_deltas(_mfcc(wave, device), order=2, window=2).cpu().numpy()


def mfcc_raw(wave, device) -> np.ndarray:
    """13-dim MFCC of one 8 kHz wave on `device` (the LDA recipes' input,
    spliced before projection), as a host array."""
    return _mfcc(wave, device).cpu().numpy()


# tests/test_sat_lda.py's corpora and options (yesno tones)
SAT_LDA_MONO = dict(num_iters=8, totgauss=40, max_iter_inc=6,
                    realign_iters=tuple(range(1, 8)))
LDA_SMALL = dict(num_iters=10, totgauss=60, max_iter_inc=8, num_leaves=20,
                 lda_dim=20, realign_iters=tuple(range(1, 10)),
                 mllt_iters=(3, 6))
SAT_SMALL = dict(num_iters=10, totgauss=60, max_iter_inc=8, num_leaves=20,
                 realign_iters=tuple(range(1, 10)), fmllr_iters=(3, 6),
                 fmllr_min_count=50.0)


def _yesno_words(rng) -> list:
    return [rng.choice(["YES", "NO"]) for _ in range(rng.randint(2, 5))]


def lda_corpus(device) -> tuple:
    """test_train_lda_mllt_pipeline's data: 20 training utterances from
    RandomState(5) featurized with deltas (for the monophone) and raw (for
    LDA), then 6 test utterances, raw. -> (train_delta, train_raw, test),
    lists of (utt, feats, words)."""
    rng = np.random.RandomState(5)
    waves = []
    for i in range(20):
        ws = _yesno_words(rng)
        waves.append((f"u{i}", yesno_synth(ws, rng), ws))
    test = []
    for i in range(6):
        ws = _yesno_words(rng)
        test.append((f"t{i}", mfcc_raw(yesno_synth(ws, rng), device), ws))
    return ([(u, mfcc_deltas(w, device), ws) for u, w, ws in waves],
            [(u, mfcc_raw(w, device), ws) for u, w, ws in waves], test)


def sat_corpus(device) -> tuple:
    """test_train_sat_beats_si_on_warped_speakers's data: 3 speakers, each
    a fixed affine distortion of the 39-dim features, 7 training
    utterances each from RandomState(6) and 3 test utterances each from
    RandomState(100 + k). -> (train [(utt, feats, words, spk)], test
    [(utt, feats, spk)], refs {utt: words})."""
    rng = np.random.RandomState(6)
    D = 39
    warps = {}
    for s in range(3):
        warps[f"s{s}"] = (np.eye(D) + rng.randn(D, D) * 0.05,
                          rng.randn(D) * 1.5)

    def corpus(rng, n, spk, warp):
        out = []
        for i in range(n):
            ws = _yesno_words(rng)
            f = mfcc_deltas(yesno_synth(ws, rng), device)
            f = f @ warp[0].T + warp[1]
            out.append((f"u{spk}_{i}", f.astype(np.float32), ws))
        return out

    train = [(u, f, ws, s) for s, warp in warps.items()
             for (u, f, ws) in corpus(rng, 7, s, warp)]
    test, refs = [], {}
    for s, warp in warps.items():
        for (u, f, ws) in corpus(np.random.RandomState(100 + int(s[1])), 3,
                                 "t" + s, warp):
            test.append((u, f, s))
            refs[u] = ws
    return train, test, refs


def pad_batch(feats_list: list) -> tuple:
    """[T_b, D] arrays -> (feats [B, T, D] zero-padded, num_frames [B])."""
    B = len(feats_list)
    T = max(f.shape[0] for f in feats_list)
    feats = np.zeros((B, T, feats_list[0].shape[1]), np.float32)
    nf = np.zeros(B, np.int32)
    for b, f in enumerate(feats_list):
        feats[b, : f.shape[0]] = f
        nf[b] = f.shape[0]
    return feats, nf


def gmm_hclg(lang, arpa: str, tm, ctx):
    """The HCLG of `lang` and an ARPA LM for a transition model, by the
    port's copies of the graph stack (self-loop scale 0.1), packed."""
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    g = arpa_to_g(ArpaLm.parse(arpa), lang.words)
    hclg = make_hclg(lang, g, tm, ctx, self_loop_scale=0.1)
    return pack_graph(hclg.fst, tm.id2pdf_array)


def gmm_stack(lexicon: str, arpa: str):
    """A lexicon's lang (SIL with 3 states), its monophone context and
    flat-start transition model, and their HCLG -> (lang, ctx, tm,
    packed HCLG)."""
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.tree.context_dep import MonophoneContextDependency
    lang = prepare_lang(Lexicon.parse(lexicon), ["SIL"], "SIL",
                        num_sil_states=3)
    ctx = MonophoneContextDependency.from_topo(lang.topo)
    tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    return lang, ctx, tm, gmm_hclg(lang, arpa, tm, ctx)


def random_am(counts, dim: int, seed: int, device):
    """An AmDiagGmm with counts[i] gaussians in pdf i, drawn from a seed."""
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    rng = np.random.RandomState(seed)
    return AmDiagGmm([DiagGmm(rng.dirichlet(np.ones(m)),
                              rng.randn(m, dim) * 2.0,
                              rng.uniform(0.3, 2.0, (m, dim)))
                      for m in counts], device)


def dense_hub_graph(n_words: int = 100, P: int = 7):
    """State 0 enters n_words word states (word w: ilabel w, olabel w);
    each word state returns to 0 and loops; one eps arc from state 1 to
    0. State 0's in-degree n_words + 1 > 64 puts it in the dense
    decoder's hub table. Integer costs: paths tie."""
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    rng = np.random.RandomState(4)
    arcs = []
    for w in range(1, n_words + 1):
        arcs.append((0, w, w, w, float(rng.randint(0, 3)), w % P))
        arcs.append((w, 0, n_words + w, 0, float(rng.randint(0, 2)),
                     (w + 1) % P))
        arcs.append((w, w, 2 * n_words + w, 0, 1.0, w % P))
    arcs.append((1, 0, 0, 0, 0.0, -1))
    arcs.sort(key=lambda a: (a[0], -(a[2] > 0)))
    src = np.array([a[0] for a in arcs])
    final = np.full(n_words + 1, np.inf, np.float32)
    final[0] = 0.0
    return PackedGraph(
        arc_start=np.searchsorted(src, np.arange(n_words + 2)).astype(
            np.int32),
        ilabel=np.array([a[2] for a in arcs], np.int32),
        olabel=np.array([a[3] for a in arcs], np.int32),
        cost=np.array([a[4] for a in arcs], np.float32),
        nextstate=np.array([a[1] for a in arcs], np.int32),
        final=final, start=0, pdf=np.array([a[5] for a in arcs], np.int32))


def star_hub_graph(n_words=300):
    """State 0 fans out n_words arcs with distinct pdfs (so the hub's pdf
    groups exceed 128 and the hub gathers through the kernel); every word
    state loops back to 0."""
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    deg = np.r_[n_words, np.ones(n_words, np.int64)]
    arc_start = np.r_[0, np.cumsum(deg)].astype(np.int32)
    n_arcs = int(arc_start[-1])
    rng = np.random.RandomState(0)
    il = np.r_[np.arange(1, n_words + 1),
               np.full(n_words, n_words + 1)].astype(np.int32)
    ol = np.r_[np.arange(1, n_words + 1), np.zeros(n_words)].astype(np.int32)
    cost = np.r_[rng.rand(n_words), np.full(n_words, 0.25)].astype(np.float32)
    nxt = np.r_[np.arange(1, n_words + 1), np.zeros(n_words)].astype(np.int32)
    pdf = np.r_[np.arange(n_words), np.full(n_words, n_words)].astype(np.int32)
    final = np.full(n_words + 1, np.inf, np.float32)
    final[0] = 0.0
    assert len(il) == n_arcs
    return PackedGraph(start=0, arc_start=arc_start, ilabel=il, olabel=ol,
                       cost=cost, nextstate=nxt, pdf=pdf, final=final)


def cuda_ms(fn, reps: int = 20, per: int = 100) -> float:
    """Device time of one call in ms: `per` calls captured in one CUDA
    graph, replayed `reps` times between CUDA events; the median replay
    over `per`. The graph takes the host's launch cost out of the
    number, which back-to-back eager calls from Python would measure
    instead. Inputs stay L2-resident between calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / per)
    return float(np.median(ts))


def gather_bound_ms(B: int, P: int, N: int) -> float:
    """Least time for one gather: the index read and the output write (4 B
    each per element) and the table read once, over the HBM rate. It does
    no arithmetic, so bytes bound it."""
    return (8 * B * N + 4 * B * P) / HBM_BYTES_PER_S * 1e3


def qaffine_bound_ms(M: int, K: int, N: int,
                     passes: int = 1) -> tuple[float, str]:
    """Least time for one qaffine call: the larger of its 2MNK FLOPs over
    the dense bf16 tensor-core rate and its bytes (x, int8 weights, scale
    and bias read once, y written once) over the HBM rate. passes=3 gives
    the ceiling of the kernel's design, which multiplies three bf16 planes
    of x (3 x 2MNK FLOPs)."""
    t_ops = passes * 2 * M * K * N / BF16_FLOP_PER_S * 1e3
    t_bytes = (4 * M * K + N * K + 8 * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qaffine_fp32_bound_ms(M: int, K: int, N: int) -> float:
    """The same call's 2MNK FLOPs over the FP32 rate of the CUDA cores:
    the ceiling of a true-f32 design without tensor cores."""
    return 2 * M * K * N / FP32_FLOP_PER_S * 1e3


def gather_floor_fn():
    """An empty kernel launched with the gather's grid and block for a
    shape: the per-launch floor under the gather's device time."""
    import ctypes
    import torch
    from kaldi_tpu_torch import cuda_build
    fn = cuda_build.load("table_gather", "kaldi_table_gather_floor",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def launch(B: int, P: int, N: int):
        rc = fn(B, P, N, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")
    return launch


def phase_kernel(tg) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    for (B, P, N) in GATHER_SHAPES + GATHER_EDGES:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        # and the same indices one int32 past a 16-byte boundary (scalar
        # loads and stores)
        moved = torch.empty(B * N + 1, dtype=torch.int32,
                            device="cuda")[1:].view(B, N)
        moved.copy_(idx)
        want = torch.gather(tab, 1, idx.long())
        for i in (idx, moved):
            got = tg.gather_cuda(tab, i)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != torch.gather at "
                                     f"{(B, P, N)}, index base "
                                     f"{i.data_ptr() % 16} mod 16")
            err = max(err, float((got - want).abs().max()))
    # out-of-range indices give 0.0, as in the TPU kernel
    tab = torch.randn(2, 100, device="cuda", generator=g)
    idx = torch.tensor([[-1, 0, 99, 100], [5, 1000, -7, 3]],
                       dtype=torch.int32, device="cuda")
    if not torch.equal(tg.gather_cuda(tab, idx),
                       tg.batched_table_gather_ref(tab, idx)):
        raise AssertionError("kernel != plain version on out-of-range indices")
    torch.cuda.synchronize()
    floor = gather_floor_fn()
    times = {}
    for (B, P, N) in GATHER_SHAPES:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        il = idx.long()
        times[(B, P, N)] = (cuda_ms(lambda: tg.gather_cuda(tab, idx)),
                            cuda_ms(lambda: tg.batched_table_gather_ref(tab,
                                                                        idx)),
                            cuda_ms(lambda: torch.gather(tab, 1, il)),
                            cuda_ms(lambda: floor(B, P, N)))
        k_ms, p_ms, l_ms, f_ms = times[(B, P, N)]
        log(f"  gather tab [{B}, {P}] idx [{B}, {N}]: kernel {k_ms:.6f} ms, "
            f"plain version {p_ms:.6f} ms, torch.gather alone {l_ms:.6f} "
            f"ms, empty kernel at the same grid (launch floor) {f_ms:.6f} "
            f"ms, bound {gather_bound_ms(B, P, N):.6f} ms by bytes (device "
            f"time per call: CUDA graph of 100 calls, median of 20 replays)")
    log(f"  kernel bit-exact at {len(GATHER_SHAPES + GATHER_EDGES)} shapes, "
        f"each with an aligned and a misaligned index base, and on "
        f"out-of-range indices")
    return {"max_abs_err": err, "times": times}


def _qaffine_case(M: int, K: int, N: int, g):
    """x [M, K] and bias [N] from the card's generator; int8 weights
    quantized (numpy) from seeded normal weights of stddev 1/sqrt(K)."""
    import torch
    from kaldi_tpu_torch.nnet.quantized import quantize_weights
    rng = np.random.default_rng(7 * M + 3 * K + N)
    wq, sc = quantize_weights(rng.standard_normal((N, K)).astype(np.float32)
                              / np.sqrt(K))
    x = torch.randn(M, K, device="cuda", generator=g)
    b = torch.randn(N, device="cuda", generator=g)
    return x, torch.from_numpy(wq).cuda(), torch.from_numpy(sc).cuda(), b


def phase_qaffine(q) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    worst_abs = worst_rel = 0.0
    for (M, K, N) in [sh for sh, _n in QAFFINE_SHAPES] + QAFFINE_EDGES:
        x, wq, sc, b = _qaffine_case(M, K, N, g)
        got = q.qaffine_cuda(x, wq, sc, b)
        torch.cuda.synchronize()
        want = q.qaffine_ref(x, wq, sc, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        # the tensor cores' f32 sums truncate and run in another order
        # over K <= 2048: 1e-5 of the output's scale; at the JAX test's
        # shape atol 1e-4, as
        # tests/test_quantized.py:53 holds the Pallas kernel
        lim = 1e-4 if (M, K, N) == (40, 128, 128) else 1e-5 * top
        if not err <= lim:
            raise AssertionError(f"qaffine kernel vs plain at {(M, K, N)}: "
                                 f"max abs err {err} > {lim}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / top)
    log(f"  kernel within tolerance at {len(QAFFINE_SHAPES)} path shapes and "
        f"{len(QAFFINE_EDGES)} edges: max abs err {worst_abs:.3e}, max "
        f"err / max|y| {worst_rel:.3e}")
    f64 = qaffine_f64_errors(q, g)
    times = {}
    for (M, K, N), _n in QAFFINE_SHAPES:
        x, wq, sc, b = _qaffine_case(M, K, N, g)
        w_deq_t = (wq.to(torch.float32) * sc[:, None]).T    # [K, N] f32
        times[(M, K, N)] = (
            cuda_ms(lambda: q.qaffine_cuda(x, wq, sc, b), per=10),
            cuda_ms(lambda: q.qaffine_ref(x, wq, sc, b), per=10),
            cuda_ms(lambda: torch.addmm(b, x, w_deq_t), per=10))
        (bound, by), (ceil, _) = (qaffine_bound_ms(M, K, N),
                                  qaffine_bound_ms(M, K, N, passes=3))
        k_ms, p_ms, l_ms = times[(M, K, N)]
        log(f"  qaffine x [{M}, {K}] wq [{N}, {K}]: kernel {k_ms:.6f} ms "
            f"({2 * M * K * N / k_ms / 1e9:.1f} TFLOP/s of products, "
            f"{6 * M * K * N / k_ms / 1e9:.1f} as three bf16 passes), plain "
            f"version {p_ms:.6f} ms, torch.addmm on f32 weights {l_ms:.6f} "
            f"ms, bound {bound:.6f} ms by {by} (three bf16 passes would "
            f"take {ceil:.6f} ms; FP32 FMAs "
            f"{qaffine_fp32_bound_ms(M, K, N):.6f} ms) (device time per "
            f"call: CUDA graph of 10 calls, median of 20 replays)")
    per_req = [sum(n * times[sh][i] for sh, n in QAFFINE_SHAPES)
               for i in range(3)]

    def per_request(passes: int) -> tuple[float, str]:
        """A request's bound, summed over its calls, and the kind that
        holds most of it (the K = 200 call alone is bound by bytes)."""
        parts = [(n * b, kind) for (b, kind), n in
                 ((qaffine_bound_ms(*sh, passes=passes), n)
                  for sh, n in QAFFINE_SHAPES)]
        return (sum(b for b, _k in parts),
                max(("operations", "bytes"),
                    key=lambda kind: sum(b for b, k in parts if k == kind)))
    (bound_req, by), (ceil_req, ceil_by) = per_request(1), per_request(3)
    fp32_req = sum(n * qaffine_fp32_bound_ms(*sh) for sh, n in QAFFINE_SHAPES)
    log(f"  per request (6 calls): kernel {per_req[0]:.6f} ms, plain "
        f"{per_req[1]:.6f} ms, torch.addmm {per_req[2]:.6f} ms (it reads "
        f"f32 weights: 4x the int8 bytes), bound {bound_req:.6f} ms by "
        f"{by} (2MNK at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, or bytes) = "
        f"{100 * bound_req / per_req[0]:.1f}% of the kernel's time; the "
        f"design's ceiling, three bf16 passes, {ceil_req:.6f} ms by "
        f"{ceil_by} = {100 * ceil_req / per_req[0]:.1f}%; the FP32-FMA "
        f"bound of a true-f32 design {fp32_req:.6f} ms")
    if not per_req[0] < per_req[2]:
        raise AssertionError(f"qaffine {per_req[0]:.6f} ms per request is "
                             f"not below torch.addmm's {per_req[2]:.6f} ms")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": per_req[0], "plain_ms": per_req[1],
            "library_ms": per_req[2], "bound_ms": bound_req, "bound_by": by,
            "three_pass_bound_ms": ceil_req, "fp32_bound_ms": fp32_req,
            **f64}


# x with full 24-bit mantissas at small K, where the accumulation adds
# little error: a kernel that drops the lo plane of x (2^-17 of each x)
# lands near 2e-6 of max|y| against the f64 product, a three-pass one
# near 1e-7 (as tests/test_torch_cuda.py holds it)
QAFFINE_ALL_OF_X = [(256, 16, 256), (512, 64, 512)]
QAFFINE_ALL_OF_X_LIM = 1e-6


def qaffine_f64_errors(q, g) -> dict:
    """Kernel and plain version against the product in f64: err / max|y|
    at each path shape, and the kernel at QAFFINE_ALL_OF_X held to
    QAFFINE_ALL_OF_X_LIM."""
    import torch

    def rel(M, K, N):
        x, wq, sc, b = _qaffine_case(M, K, N, g)
        want = ((x.double() @ wq.double().T) * sc.double() + b.double())
        top = float(want.abs().max())
        return [float((f(x, wq, sc, b).double() - want).abs().max()) / top
                for f in (q.qaffine_cuda, q.qaffine_ref)]
    for sh in QAFFINE_ALL_OF_X:
        k_rel, _p = rel(*sh)
        if not k_rel <= QAFFINE_ALL_OF_X_LIM:
            raise AssertionError(f"qaffine vs f64 at {sh}: err / max|y| "
                                 f"{k_rel:.3e} > {QAFFINE_ALL_OF_X_LIM}")
        log(f"  kernel vs f64 at {sh} (full-mantissa x): err / max|y| "
            f"{k_rel:.3e} <= {QAFFINE_ALL_OF_X_LIM}")
    worst = [0.0, 0.0]
    for sh, _n in QAFFINE_SHAPES:
        k_rel, p_rel = rel(*sh)
        torch.cuda.synchronize()
        worst = [max(worst[0], k_rel), max(worst[1], p_rel)]
        log(f"  vs f64 at {sh}: err / max|y| kernel {k_rel:.3e}, plain f32 "
            f"version {p_rel:.3e}")
    return {"max_rel_err_f64": worst[0], "plain_max_rel_err_f64": worst[1]}


def _same_results(name: str, got: list, want: list, what: str):
    """Identical words and tids, cost within 1e-2, per utterance."""
    for b, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: utt {b} hypothesis presence")
        if g is None:
            continue
        if list(g[0]) != list(w[0]) or list(g[1]) != list(w[1]) \
                or abs(g[2] - w[2]) > 1e-2:
            raise AssertionError(f"{name}: utt {b} differs: {what} {g} "
                                 f"reference {w}")


def phase_int8_parity():
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import make_corpus
    from kaldi_tpu_torch.nnet.quantized import QuantizedTdnn, quantize_tdnn
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import Recognizer
    graph, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=64,
                     nonlinearity="relu")
    qtree = quantize_tdnn(random_tdnn_params(cfg, np.random.default_rng(0)))
    waves, _segs, _words = make_corpus(graph, 2, 200,
                                       np.random.default_rng(0), noise=0.25)
    opts = CsrBeamOpts(beam=13.0, max_active=512, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024)
    res = {dev: Recognizer(QuantizedTdnn(cfg).load_jax_qparams(qtree), graph,
                           opts, device=dev, compute_dtype=None
                           ).recognize(waves)
           for dev in ("cuda", "cpu")}
    if any(r is None for r in res["cuda"]):
        raise AssertionError("int8 decode: an utterance has no hypothesis")
    _same_results("int8 decode", res["cuda"], res["cpu"], "cuda")
    log(f"  int8 decode cuda == cpu (words, tids; cost within 1e-2): "
        f"{[len(r[0]) for r in res['cuda']]} words")


def phase_decoder_parity():
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    small, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    base = dict(beam=9.0, max_active=256, acoustic_scale=0.1,
                expand_budget=4096, eps_budget=1024)
    cases = [("small fold_eps", small, 64, dict(base, fold_eps=True)),
             ("small eps rounds", small, 64, dict(base, fold_eps=False)),
             ("small hub tier", small, 64, dict(base, hub_threshold=64)),
             ("star hub G>128", star_hub_graph(300), 301,
              dict(base, max_active=128, hub_threshold=32))]
    rng = np.random.RandomState(0)
    for name, graph, P, kw in cases:
        B, T = 3, 40
        ll = (rng.randn(B, T, P) * 3).astype(np.float32)
        nf = np.array([40, 29, 17], np.int32)
        opts = CsrBeamOpts(**kw)
        dg = CsrBeamDecoder(graph, opts, device="cuda")
        dc = CsrBeamDecoder(graph, opts, device="cpu")
        rg, rc = dg.decode(ll, nf), dc.decode(ll, nf)
        for b in range(B):
            if (rg[b] is None) != (rc[b] is None):
                raise AssertionError(f"{name}: utt {b} hypothesis presence")
            if rg[b] is None:
                continue
            if rg[b][0] != rc[b][0] or rg[b][1] != rc[b][1] \
                    or abs(rg[b][2] - rc[b][2]) > 1e-2:
                raise AssertionError(f"{name}: utt {b} differs: cuda {rg[b]} "
                                     f"cpu {rc[b]}")
        for attr in ("last_overflow", "last_saturated", "last_active_sum",
                     "last_active_max"):
            if not np.array_equal(getattr(dg, attr), getattr(dc, attr)):
                raise AssertionError(f"{name}: {attr} differs")
        log(f"  {name}: cuda == cpu (words, tids, counters; cost within "
            f"1e-2), overflow {dg.last_overflow.tolist()}")


def phase_slice(tg, card: str, profile: bool = False) -> dict:
    import torch
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import make_corpus
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import Recognizer

    t0 = time.perf_counter()
    graph, _ = make_big_hclg(BigGraphConfig())
    cfg = TdnnConfig(feat_dim=40, num_pdfs=2048, hidden_dim=1024,
                     pnorm_output_dim=256, nonlinearity="relu")
    tdnn = Tdnn(cfg).load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(0)))
    waves, _segs, ref_words = make_corpus(graph, 8, 1000,
                                          np.random.default_rng(0),
                                          noise=0.25)
    t1 = time.perf_counter()
    rec = Recognizer(tdnn, graph, CsrBeamOpts(
        beam=13.0, max_active=7000, acoustic_scale=0.1,
        expand_budget=16384, eps_budget=2048), device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  graph {graph.num_states} states / {graph.num_arcs} arcs, "
        f"{rec.decoder.graph.num_arcs} after eps folding; corpus 8 x 10 s; "
        f"both built in {t1 - t0:.3f} s on the host; "
        f"decoder set-up (fold, pack, upload): {t2 - t1:.3f} s; "
        f"tier-B layout {rec.decoder.tabs.b_apr} arcs/row, "
        f"{len(rec.decoder.tabs.hub_bounds) - 1} hub(s), hub one-hot "
        f"{rec.decoder.tabs.hub_onehot is not None}")

    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    B, T, P = ll.shape
    if (B, P) != (8, 2048) or not bool(torch.isfinite(ll).all()):
        raise AssertionError(f"loglikes {tuple(ll.shape)} not finite/shaped")

    tg.launches = 0                       # count the main path only
    answers, secs = [], []
    for _ in range(3):
        t = time.perf_counter()
        answers.append(rec.recognize(waves))
        secs.append(time.perf_counter() - t)
    launches = tg.launches
    if launches < 2 * T * 3:
        raise AssertionError(f"{launches} gather launches for 3 x {T} frames")
    if any(a != answers[0] for a in answers[1:]):
        raise AssertionError("repeated requests gave different answers")
    res = answers[0]
    if any(r is None for r in res):
        raise AssertionError("an utterance has no hypothesis")
    dec = rec.decoder
    audio = B * waves.shape[1] / 16000.0
    steady = float(np.median(secs[1:]))
    corpus_wer = wer([list(w) for w in ref_words], [r[0] for r in res])
    log(f"  slice: {audio / steady:.3f} audio-sec/s (median of requests 2-3), "
        f"per-request s {[round(s, 4) for s in secs]}, {T} frames x {B} "
        f"utts, gather launches {launches} ({launches / (3 * T):.1f}/frame), "
        f"overflow sum {int(dec.last_overflow.sum())}, active tokens mean "
        f"{dec.last_active_sum.sum() / (B * T):.1f} peak "
        f"{int(dec.last_active_max.max())}, saturated "
        f"{int(dec.last_saturated.sum())}/{B}, corpus WER "
        f"{corpus_wer:.2f}% (untrained random-weight AM: not a quality "
        f"number) | card: {card}")

    # one more request, split by layer (host clock around synchronize)
    t0 = time.perf_counter()
    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    finish = dec.decode_async(ll, np.full(B, T, np.int32))
    t2 = time.perf_counter()
    if finish() != res:
        raise AssertionError("layer-split request gave a different answer")
    t3 = time.perf_counter()
    log(f"  layers: fbank+CMVN+TDNN {t1 - t0:.4f} s; decoder host loop "
        f"(enqueue {T} frames + traceback) {t2 - t1:.4f} s; device drain + "
        f"one copy + parse {t3 - t2:.4f} s")
    if profile:
        profile_decode(dec, ll, 200, (t2 - t1) / T)
    return {"launches": launches, "graph": graph, "waves": waves,
            "ref_words": ref_words, "decoder": dec, "cfg": cfg, "rec": rec}


def phase_int8_slice(q, tg, sl: dict, card: str) -> dict:
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.nnet.quantized import QuantizedTdnn, quantize_tdnn
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import Recognizer

    cfg, waves = sl["cfg"], sl["waves"]
    qmodel = QuantizedTdnn(cfg).load_jax_qparams(
        quantize_tdnn(random_tdnn_params(cfg, np.random.default_rng(0))))
    rec = Recognizer(qmodel, sl["graph"], CsrBeamOpts(
        beam=13.0, max_active=7000, acoustic_scale=0.1,
        expand_budget=16384, eps_budget=2048), device="cuda",
        compute_dtype=None)
    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    tdnn_s = time.perf_counter() - t
    B, T, P = ll.shape
    if (B, P) != (8, 2048) or not bool(torch.isfinite(ll).all()):
        raise AssertionError(f"int8 loglikes {tuple(ll.shape)} not "
                             f"finite/shaped")

    q.launches = tg.launches = 0          # count the int8 path only
    answers, secs = [], []
    for _ in range(3):
        t = time.perf_counter()
        answers.append(rec.recognize(waves))
        secs.append(time.perf_counter() - t)
    launches, g_launches = q.launches, tg.launches
    if launches != 6 * 3:
        raise AssertionError(f"{launches} qaffine launches in 3 requests, "
                             f"want 6 per request")
    if g_launches < 2 * T * 3:
        raise AssertionError(f"{g_launches} gather launches for 3 x {T} "
                             f"frames")
    if any(a != answers[0] for a in answers[1:]):
        raise AssertionError("repeated int8 requests gave different answers")
    res = answers[0]
    if any(r is None for r in res):
        raise AssertionError("an utterance has no hypothesis (int8)")
    dec = rec.decoder
    audio = B * waves.shape[1] / 16000.0
    steady = float(np.median(secs[1:]))
    corpus_wer = wer([list(w) for w in sl["ref_words"]], [r[0] for r in res])
    log(f"  int8 slice: {audio / steady:.3f} audio-sec/s (median of requests "
        f"2-3), per-request s {[round(s_, 4) for s_ in secs]}, fbank+CMVN+"
        f"int8 TDNN {tdnn_s:.4f} s, qaffine launches {launches} "
        f"({launches // 3}/request), gather launches {g_launches} "
        f"({g_launches / (3 * T):.1f}/frame), overflow sum "
        f"{int(dec.last_overflow.sum())}, active tokens mean "
        f"{dec.last_active_sum.sum() / (B * T):.1f} peak "
        f"{int(dec.last_active_max.max())}, corpus WER {corpus_wer:.2f}% "
        f"(untrained random-weight AM: not a quality number) | card: {card}")
    # the host loop sets both paths' request time and its speed drifts
    # within a call, so the two are compared in turns
    turns = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        r = sl["rec"] if name == "bf16" else rec
        t = time.perf_counter()
        r.recognize(waves)
        turns[name].append(time.perf_counter() - t)
    log(f"  in turns (bf16, int8, int8, bf16): request s bf16 "
        f"{[round(x, 4) for x in turns['bf16']]} int8 "
        f"{[round(x, 4) for x in turns['int8']]}")
    return {"launches": launches}


def _stream_all(srv, waves: list, sizes: list) -> tuple[list, list]:
    """Open one slot per wave, feed each `sizes[i]` samples per step until
    all is fed, flush, and read every stream's best path. -> (results,
    host seconds of each step, each ending in a device sync)."""
    slots = [srv.open() for _ in waves]
    pos = [0] * len(waves)
    step_s = []

    def step():
        t = time.perf_counter()
        srv.step()
        srv.sync()
        step_s.append(time.perf_counter() - t)

    while any(p < len(w) for p, w in zip(pos, waves)):
        for i, w in enumerate(waves):
            if pos[i] < len(w):
                srv.feed(slots[i], w[pos[i]: pos[i] + sizes[i]])
                pos[i] += sizes[i]
        step()
    for s in slots:
        srv.input_finished(s)
    while not all(srv.finished(s) for s in slots):
        step()
    out = [srv.best_path(s) for s in slots]
    for s in slots:
        srv.close(s)
    return out, step_s


def _offline(am, dec, waves: list, fb) -> list:
    """The offline decode of each wave on the decoder's device: fbank ->
    AmNnet.loglikes -> CsrBeamDecoder.decode, one batch if the waves are
    all of one length."""
    import torch
    from kaldi_tpu_torch.ops.features import fbank
    if len({len(w) for w in waves}) > 1:
        return [r for w in waves for r in _offline(am, dec, [w], fb)]
    feats = fbank(torch.as_tensor(np.stack(waves), device=dec.device), fb)
    ll = am.loglikes(feats)
    return dec.decode(ll, np.full(len(waves), feats.shape[1], np.int32))


def small_stream_setup() -> dict:
    """tests/test_fused_serving.py's fixture, with seeded weights and
    priors: 24-bin fbank, the 40-word HCLG, a relu TDNN of width 64 over
    16 pdfs."""
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.ops.features import FbankOpts
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.params import random_tdnn_params
    graph, _ = make_big_hclg(BigGraphConfig(vocab=40, avg_bigram_succ=6,
                                            num_pdfs=16, seed=3))
    cfg = TdnnConfig(feat_dim=24, num_pdfs=16, hidden_dim=64,
                     pnorm_output_dim=32, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    return dict(
        fb=FbankOpts(frame_opts=FrameOpts(dither=0.0),
                     mel_opts=MelOpts(num_bins=24)),
        graph=graph, cfg=cfg,
        params=random_tdnn_params(cfg, np.random.default_rng(0)),
        priors=np.random.default_rng(1).dirichlet(np.ones(16)),
        opts=CsrBeamOpts(beam=11.0, max_active=128, acoustic_scale=0.1,
                         expand_budget=2048, eps_budget=512,
                         hub_threshold=64))


def small_stream_server(su: dict, dev: str, **kw):
    """The small fixture's AmNnet, decoder and server on `dev`."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.serving import FusedStreamingServer
    am = AmNnet(Tdnn(su["cfg"]).load_jax_params(su["params"]),
                priors=su["priors"])
    dec = CsrBeamDecoder(su["graph"], su["opts"], device=dev)
    return am, dec, FusedStreamingServer(am, dec, su["fb"],
                                         chunk_samples=2560, t_max=256, **kw)


def phase_stream_small():
    su = small_stream_setup()
    fb = su["fb"]
    rng = np.random.default_rng(21)
    waves = [rng.standard_normal(L).astype(np.float32) * 4000
             for L in (9000, 17000, 30000, 12345)]
    res = {}
    for dev in ("cuda", "cpu"):
        am, dec, srv = small_stream_server(su, dev, n_streams=4)
        res[dev], _ = _stream_all(srv, waves, [2560, 1300, 5000, 2000])
        if dev == "cuda":
            offline = _offline(am, dec, waves, fb)
    if any(r is None for r in res["cuda"]):
        raise AssertionError("small streaming: a stream has no hypothesis")
    _same_results("small streaming", res["cuda"], res["cpu"], "cuda server")
    _same_results("small streaming", res["cuda"], offline, "cuda server")
    log(f"  4 streams, mixed lengths and feed sizes: card == CPU (words, "
        f"tids; cost within 1e-2) and card == offline decode on the card; "
        f"{[len(r[0]) for r in res['cuda']]} words")


def phase_stream_full(tg, sl: dict, card: str,
                      profile: bool = False) -> dict:
    import torch
    from kaldi_tpu_torch.decoder.simulate import make_corpus
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.serving import FusedStreamingServer
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import SERVING_FBANK

    cfg, dec = sl["cfg"], sl["decoder"]
    n, chunk = 16, 2560
    am = AmNnet(Tdnn(cfg).load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(0))),
        priors=np.random.default_rng(2).dirichlet(np.ones(cfg.num_pdfs)))
    waves, _segs, ref_words = make_corpus(sl["graph"], n, 1000,
                                          np.random.default_rng(1),
                                          noise=0.25)
    srv = FusedStreamingServer(am, dec, SERVING_FBANK, n_streams=n,
                               chunk_samples=chunk, t_max=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tg.launches = 0                       # count the streaming path only
    t0 = time.perf_counter()
    res, step_s = _stream_all(srv, list(waves), [chunk] * n)
    wall = time.perf_counter() - t0
    launches = tg.launches
    frames = int(srv._decoded.max())
    if launches < 2 * frames:
        raise AssertionError(f"{launches} gather launches for {frames} "
                             f"lockstep frames")
    in_use = torch.cuda.memory_allocated() / 2**30
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    offline = _offline(am, dec, list(waves), SERVING_FBANK)
    off_s = time.perf_counter() - t
    if any(r is None for r in res):
        raise AssertionError("full-width streaming: a stream has no "
                             "hypothesis")
    _same_results("full-width streaming", res, offline, "server")
    ms = np.asarray(step_s) * 1e3
    p50, p95 = float(np.percentile(ms, 50)), float(np.percentile(ms, 95))
    n = len(res)
    audio = n * waves.shape[1] / 16000.0
    chunk_ms = 1e3 * chunk / 16000.0
    corpus_wer = wer([list(w) for w in ref_words], [r[0] for r in res])
    log(f"  streaming: {n} streams x {waves.shape[1] / 16000.0:.1f} s, "
        f"{len(step_s)} steps of {chunk_ms:.0f} ms chunks, {frames} frames; "
        f"step ms p50 {p50:.3f} p95 {p95:.3f} max {ms.max():.3f} "
        f"(p95 < {chunk_ms:.0f} ms: {p95 < chunk_ms}); {audio / wall:.3f} "
        f"audio-sec/s aggregate over {wall:.3f} s (feeding, steps and "
        f"best_path); gather launches {launches} "
        f"({launches / frames:.1f}/frame step); device memory in use "
        f"{in_use:.3f} GiB, peak {peak:.3f} GiB; all {n} streams == offline "
        f"decode on the card (words, tids; offline took {off_s:.3f} s); "
        f"corpus WER {corpus_wer:.2f}% (untrained random-weight AM: not a "
        f"quality number) | card: {card}")
    if profile:
        profile_stream(srv, list(waves), chunk, p50 / 1e3)
    return {"launches": launches}


def _same_records(name: str, got: dict, want: dict, f16: bool):
    """decode_raw results: the same keys, shapes and dtypes; ints and
    scores rebuilt from float16 identical, other floats within 1e-5."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: record keys {list(got)}")
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {key} {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        exact = w.dtype.kind != "f" or (f16 and key in ("scores",
                                                       "init_scores"))
        if exact and not np.array_equal(g, w):
            raise AssertionError(f"{name}: {key} differs")
        if not exact and np.abs(g - w).max(initial=0) > 1e-5:
            raise AssertionError(f"{name}: {key} off by "
                                 f"{np.abs(g - w).max()}")


def lattice_form(lat) -> tuple:
    """A lattice without its node numbering: node and arc counts and the
    sorted (ilabel, olabel, graph cost, acoustic cost) of its arcs."""
    n, _src, il, ol, gc, ac, _dst = lat.to_arrays()
    return n, sorted(zip(np.asarray(il).tolist(), np.asarray(ol).tolist(),
                         np.asarray(gc).tolist(), np.asarray(ac).tolist()))


def phase_lattice_small():
    import torch
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                                  ChunkedCsrBeamDecoder,
                                                  CsrBeamDecoder, CsrBeamOpts)
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.generate import (decode_to_lattices,
                                              raw_lattice_from_decode)
    from kaldi_tpu_torch.ops.features import fbank
    small, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    base = dict(beam=10.0, max_active=256, acoustic_scale=0.1,
                expand_budget=8192, eps_budget=2048)
    rec = dict(base, rec_cap=128, rec_beam=6.0)
    cases = [("dense", small, 64, base),
             ("f16", small, 64, dict(rec, rec_f16=True)),
             ("flat", small, 64, dict(rec, rec_f16=True, rec_flat=True,
                                      rec_flat_cap=128)),
             ("init rounds", small, 64, dict(rec, fold_eps=False)),
             ("star hub G>128, flat", star_hub_graph(300), 301,
              dict(base, max_active=128, hub_threshold=32, rec_cap=96,
                   rec_beam=8.0, rec_f16=True, rec_flat=True,
                   rec_flat_cap=96))]
    rng = np.random.RandomState(1)
    for name, graph, P, kw in cases:
        ll = (rng.randn(2, 25, P) * 3).astype(np.float32)
        nf = np.array([25, 19], np.int32)
        opts = CsrBeamOpts(**kw)
        dg = CsrBeamDecoder(graph, opts, device="cuda")
        dc = CsrBeamDecoder(graph, opts, device="cpu")
        rg, rc = dg.decode_raw(ll, nf), dc.decode_raw(ll, nf)
        _same_records(name, rg, rc, bool(kw.get("rec_f16")))
        for attr in ("last_overflow", "last_saturated", "last_rec_trunc",
                     "last_active_sum", "last_active_max",
                     "last_flat_fallbacks"):
            if not np.array_equal(getattr(dg, attr), getattr(dc, attr)):
                raise AssertionError(f"{name}: {attr} differs")
        sizes = []
        for b in range(2):
            lats = {(d, native): raw_lattice_from_decode(
                        dec, r, nf, b, 6.0, use_native=native)
                    for d, dec, r in (("cuda", dg, rg), ("cpu", dc, rc))
                    for native in (True, False)}
            form = lattice_form(lats["cuda", True])
            best = lattice_best_path(lats["cuda", True])
            for key, lat in lats.items():
                if lattice_form(lat) != form:
                    raise AssertionError(f"{name}: utt {b} lattice {key} "
                                         f"differs from the card's native")
                if lattice_best_path(lat)[:2] != best[:2]:
                    raise AssertionError(f"{name}: utt {b} best path {key}")
            sizes.append((form[0], len(form[1])))
        log(f"  decode_raw {name}: card == CPU (states, counters, f16 bits; "
            f"f32 within 1e-5); lattices card native == card numpy == CPU "
            f"native == CPU numpy; (states, arcs) {sizes}"
            + (f", {rg['rec_wire_slots']} wire slots" if "rec_wire_slots"
               in rg else ""))

    ll = (rng.randn(3, 50, 64) * 3).astype(np.float32)
    nf = np.array([50, 41, 23], np.int32)
    opts = CsrBeamOpts(beam=9.0, max_active=128, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024, hub_threshold=64)
    ref = CsrBeamDecoder(small, opts, device="cuda")
    want = ref.decode(ll, nf)
    for tc in (7, 16, 50):
        ch = ChunkedCsrBeamDecoder(small, opts, chunk_frames=tc,
                                   device="cuda")
        _same_results(f"chunked {tc}", ch.decode(ll, nf), want, "chunked")
        for attr in ("last_overflow", "last_saturated", "last_active_sum",
                     "last_active_max"):
            if not np.array_equal(getattr(ch, attr), getattr(ref, attr)):
                raise AssertionError(f"chunked {tc}: {attr} differs")
    full = CsrBeamOpts(beam=8.0, max_active=512, acoustic_scale=0.1,
                       expand_budget=16384, eps_budget=2048)
    ll = (rng.randn(3, 40, 64) * 3).astype(np.float32)
    nf = np.full(3, 40, np.int32)
    ad = AdaptiveCsrBeamDecoder(small, full, small_max_active=64,
                                small_expand_budget=2048, device="cuda")
    _same_results("adaptive", ad.decode(ll, nf), ad.full.decode(ll, nf),
                  "adaptive")
    log(f"  chunked (7, 16, 50 frames) == one-shot on the card; adaptive == "
        f"full on the card, escalated {ad.last_escalated.tolist()}, small "
        f"chunks {ad.last_small_chunks}")

    su = small_stream_setup()
    am, dec, srv = small_stream_server(su, "cuda", n_streams=2,
                                       keep_loglikes=True)
    rng2 = np.random.default_rng(51)
    waves = [rng2.standard_normal(L).astype(np.float32) * 4000
             for L in (12000, 9000)]
    slots = []
    for w in waves:
        s = srv.open()
        srv.feed(s, w)
        srv.input_finished(s)
        slots.append(s)
    for s in slots:
        srv.drain(s)
    for i, (s, w) in enumerate(zip(slots, waves)):
        lat = srv.get_lattice(s, 6.0)
        feats = fbank(torch.as_tensor(w, device="cuda"), su["fb"])
        off = decode_to_lattices(dec, am.loglikes(feats[None]),
                                 np.array([feats.shape[0]], np.int32),
                                 6.0)[0]
        if lat is None or off is None:
            raise AssertionError(f"get_lattice stream {i}: no lattice")
        g_n, g_arcs = lattice_form(lat)
        o_n, o_arcs = lattice_form(off)
        gb, ob = lattice_best_path(lat), lattice_best_path(off)
        if (g_n != o_n or [a[:2] for a in g_arcs] != [a[:2] for a in o_arcs]
                or gb[:2] != ob[:2] or abs(gb[2] - ob[2]) > 1e-2):
            raise AssertionError(f"get_lattice stream {i} differs from the "
                                 f"offline lattice")
        log(f"  keep-loglikes server, stream {i}: get_lattice == offline "
            f"lattice on the card ({g_n} states, {len(g_arcs)} arcs, best "
            f"path {len(gb[0])} words, cost {gb[2]:.4f} vs {ob[2]:.4f})")


LATTICE_BEAM = 8.0
LATGEN_BATCHES = 2             # in the one timed run


def _sizes(lats) -> list:
    """(states, arcs) of each lattice, None where there is none."""
    return [None if x is None else (x.num_states, x.num_arcs) for x in lats]


# bench.py:60-63: the AM's training corpus and steps
TRAIN_UTTS, TEST_UTTS, TRAIN_STEPS, TIMED_TRAIN_STEPS = 16, 8, 400, 10
NG_STEPS = 20                  # two refreshes at update_period 10
SMALL_TDNN = dict(feat_dim=8, num_pdfs=12, hidden_dim=16, pnorm_output_dim=4,
                  nonlinearity="relu",
                  splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
# card vs CPU limits of the small training phase, relative to each leaf's
# max |p| and to the loss. f32 (TF32 off): cuBLAS and the CPU sum the same
# products in another order, as the port and JAX do on the CPU, so the
# bar PARITY.md pins for the train step. bf16: a sum that lands on the
# other side of a bf16 rounding boundary moves that element by 2^-8, and
# a weight that rounds differently moves its products (measured against
# JAX on the CPU after 6 steps: leaves 5.9e-3, loss 3.5e-4). NG-SGD and
# Adam: eigh (cuSOLVER against LAPACK) and Adam's division by sqrt(nu)
# each add f32 rounding on top of f32's.
TRAIN_LIMITS = {"f32": (1e-5, 1e-5), "bf16": (2e-2, 1e-3),
                "ng_sgd": (1e-4, 1e-5), "progressive": (1e-4, 1e-5)}


def _small_train_case(seed: int, nonlinearity: str = "relu"):
    """tests/test_torch_train.py's shapes: a 3-layer TDNN of width 16 over
    12 pdfs, a batch of 3 x 10 frames with uneven frame weights."""
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    cfg = TdnnConfig(**dict(SMALL_TDNN, nonlinearity=nonlinearity))
    rng = np.random.default_rng(seed)
    tree = random_tdnn_params(cfg, rng)
    batch = (rng.standard_normal((3, 17, 8)).astype(np.float32),
             rng.integers(0, 12, (3, 10)).astype(np.int32),
             rng.uniform(0.5, 1.5, (3, 10)).astype(np.float32))
    return cfg, tree, batch


def _train_small_on(dev: str, cfg, tree, batch, opt, steps: int,
                    compute_dtype=None) -> tuple[dict, list]:
    """`steps` train steps on `dev` from the numpy tree. -> (params on the
    CPU, losses)."""
    import torch
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import make_train_step
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    params = {k: v.to(dev) for k, v in tdnn_params_from_jax(tree).items()}
    state = opt.init(params)
    step = make_train_step(Tdnn(cfg), opt, compute_dtype=compute_dtype)
    b = [torch.as_tensor(a, device=dev) for a in batch]
    losses = []
    for _ in range(steps):
        params, state, loss, _acc = step(params, state, *b)
        losses.append(float(loss))
    if params["final.w"].device.type != torch.device(dev).type:
        raise AssertionError(f"train step left {dev}")
    return {k: v.cpu() for k, v in params.items()}, losses


def _train_errors(name: str, got: tuple, want: tuple) -> tuple[float, float]:
    """Card against CPU: the worst leaf error over the leaf's max |p| and
    the worst loss error over |loss|, held to TRAIN_LIMITS[name]."""
    (gp, gl), (wp, wl) = got, want
    leaf = max(float((gp[k] - wp[k]).abs().max()) /
               max(float(wp[k].abs().max()), 1e-30) for k in wp)
    loss = max(abs(a - b) / abs(b) for a, b in zip(gl, wl))
    lim_leaf, lim_loss = TRAIN_LIMITS[name]
    if not (leaf <= lim_leaf and loss <= lim_loss):
        raise AssertionError(f"{name} training, card vs CPU: leaves "
                             f"{leaf:.3e} (limit {lim_leaf}), loss "
                             f"{loss:.3e} (limit {lim_loss})")
    return leaf, loss


def phase_train_small():
    """The train step, NG-SGD, progressive training and a checkpoint on
    the card against the same on the CPU, at the CPU tests' shapes."""
    import tempfile
    import torch
    from kaldi_tpu_torch.nnet.natural_gradient import ng_sgd
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            train_progressive)
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    from kaldi_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.2, final_lr=0.05,
                                       max_grad_norm=0.5, l2_regularize=1e-2,
                                       momentum=0.9), 8)
    cases = [("f32", "clip 0.5, l2 1e-2, momentum 0.9", opt, 8, None, 3),
             ("bf16", "the same in bf16", opt, 8, torch.bfloat16, 4),
             ("ng_sgd", "NG-SGD, momentum 0.9, refresh at step 10",
              ng_sgd(0.05, alpha=0.5, update_period=10, momentum=0.9), 12,
              None, 1)]
    for name, what, o, steps, dt, seed in cases:
        cfg, tree, batch = _small_train_case(seed)
        runs = [_train_small_on(d, cfg, tree, batch, o, steps, dt)
                for d in ("cuda", "cpu")]
        leaf, loss = _train_errors(name, *runs)
        log(f"  {name}: {steps} steps ({what}), card vs CPU: leaves within "
            f"{leaf:.3e} of their max |p|, losses within {loss:.3e} (limits "
            f"{TRAIN_LIMITS[name]})")
    cfg, tree, (x, t, w) = _small_train_case(5, "pnorm")
    tree["final"]["w"][:] = 0.0
    prog = {d: train_progressive(Tdnn(cfg), tdnn_params_from_jax(tree), x, t,
                                 w, steps_per_stage=4, final_steps=6, device=d)
            for d in ("cuda", "cpu")}
    (gp, gh), (wp, wh) = prog["cuda"], prog["cpu"]
    if [h[0] for h in gh] != [1, 2, 3]:
        raise AssertionError(f"progressive stages {gh}")
    leaf, loss = _train_errors(
        "progressive", ({k: v.cpu() for k, v in gp.items()}, [h[1] for h in gh]),
        (wp, [h[1] for h in wh]))
    log(f"  train_progressive, 3 p-norm stages (Adam, 4/4/6 steps), card vs "
        f"CPU: leaves within {leaf:.3e}, stage losses within {loss:.3e}")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 12, gp, extra={"loss": gh[-1][1]})
        step, back, extra = load_checkpoint(d, like=gp)
        if step != 12 or extra["loss"] != gh[-1][1] or any(
                back[k].device != gp[k].device or not torch.equal(back[k], gp[k])
                for k in gp):
            raise AssertionError("checkpoint of card tensors did not read back")
    log(f"  checkpoint of card params written and read back equal, on the "
        f"card ({len(gp)} leaves)")


def train_flops_per_step(cfg, frames: int) -> float:
    """The bench's count (bench.py:213-216): 6 FLOPs (forward 2, backward
    4) per GEMM weight per output frame."""
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    w = sum(p.numel() for n, p in Tdnn(cfg).named_parameters()
            if n.endswith(".w"))
    return 6.0 * w * frames


def _event_ms(fn, n: int) -> float:
    """Device time of n calls between two CUDA events, per call."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def phase_train_full(sl: dict, card: str, profile: bool = False) -> dict:
    """The bench's AM training on the card with the port's train step:
    the bench's corpus (16 x 10 s, full batch), bf16 products, SGD from
    0.1 to 0.02 over 400 steps with gradients clipped at a global norm of
    5 (bench.py:173-217); then 10 timed steps, 20 NG-SGD steps and one
    f32 step at the same width. -> the corpus and the trained Tdnn."""
    import torch
    from kaldi_tpu_torch.decoder.simulate import fbank_targets, make_corpus
    from kaldi_tpu_torch.nnet.natural_gradient import ng_sgd
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)
    from kaldi_tpu_torch.ops.features import cmvn, fbank
    from kaldi_tpu_torch.params import random_tdnn_params, tdnn_params_from_jax
    from kaldi_tpu_torch.recognize import SERVING_FBANK

    cfg, graph = sl["cfg"], sl["graph"]
    t = time.perf_counter()
    waves_all, segs, ref_all = make_corpus(graph, TRAIN_UTTS + TEST_UTTS,
                                           1000, np.random.default_rng(0),
                                           noise=0.25)
    t_corpus = time.perf_counter() - t
    with torch.no_grad():
        feats = cmvn(fbank(torch.as_tensor(waves_all[:TRAIN_UTTS],
                                           device="cuda"), SERVING_FBANK))
    Tf = feats.shape[1]
    tgt = np.stack([fbank_targets(s, Tf) for s in segs[:TRAIN_UTTS]])
    tgt = torch.as_tensor(tgt[:, cfg.left_context:Tf - cfg.right_context],
                          device="cuda")
    w = torch.ones(tgt.shape, device="cuda")
    tdnn = Tdnn(cfg, device="cuda")
    init = {k: v.cuda() for k, v in tdnn_params_from_jax(
        random_tdnn_params(cfg, np.random.default_rng(0))).items()}
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.02,
                                       max_grad_norm=5.0), TRAIN_STEPS)
    step = make_train_step(tdnn, opt, compute_dtype=torch.bfloat16)
    params, state = init, opt.init(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, loss, acc = step(params, state, feats, tgt, w)
    loss, acc = float(loss), float(acc)
    t_train = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(loss) and acc > 0.5):
        raise AssertionError(f"training did not converge: loss {loss}, "
                             f"frame accuracy {acc}")
    run = {"p": params, "s": state}

    def one():
        run["p"], run["s"], run["loss"], _ = step(run["p"], run["s"], feats,
                                                  tgt, w)
    ms = _event_ms(one, TIMED_TRAIN_STEPS)
    frames = tgt.numel()
    flops = train_flops_per_step(cfg, frames)
    tflops = flops / ms / 1e9
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    log(f"  AM trained on {TRAIN_UTTS} x 10 s ({frames} output frames per "
        f"step) in {TRAIN_STEPS} steps: {t_train:.3f} s on the host clock "
        f"({1e3 * t_train / TRAIN_STEPS:.3f} ms/step); loss {loss:.4f}, frame "
        f"accuracy {acc:.4f}; peak device memory {peak:.3f} GiB (corpus "
        f"{t_corpus:.3f} s on the host) | card: {card}")
    log(f"  train step (bf16, clip + SGD), {TIMED_TRAIN_STEPS} steps between "
        f"CUDA events: {ms:.4f} ms/step, {frames / ms * 1e3:.1f} frames/s, "
        f"{tflops:.2f} TFLOP/s by the bench's count (6 x {flops / 6 / frames:.0f}"
        f" GEMM weights x frames = {flops:.4e} FLOP/step), train_mfu "
        f"{tflops * 1e12 / BF16_FLOP_PER_S:.4f} of {BF16_FLOP_PER_S / 1e12:.0f}"
        f" TFLOP/s (bound {bound_ms:.4f} ms/step) | card: {card}")
    if profile:
        busy, n_ops, by_name = device_time(lambda: [one() for _ in range(3)])
        log_profile("3 bf16 train steps", "step", 3, busy, n_ops, by_name,
                    ms / 1e3, 20)
        log_by_kind(by_name, 3, "step")
    tdnn.load_state_dict(run["p"])

    ng = ng_sgd(0.02, update_period=10)
    nrun = {"p": init, "s": ng.init(init)}
    ng_step = make_train_step(tdnn, ng, compute_dtype=torch.bfloat16)
    per = []
    for _ in range(NG_STEPS):
        per.append(_event_ms(lambda: nrun.update(zip(
            ("p", "s", "loss", "acc"),
            ng_step(nrun["p"], nrun["s"], feats, tgt, w))), 1))
    if not np.isfinite(float(nrun["loss"])):
        raise AssertionError("NG-SGD loss is not finite")
    refresh = [per[i - 1] for i in range(10, NG_STEPS + 1, 10)]
    plain = [x for i, x in enumerate(per, 1) if i % 10]
    log(f"  NG-SGD (bf16, update_period 10, {len(nrun['s'][0].factors)} "
        f"factored weights), {NG_STEPS} steps: {float(np.mean(per)):.4f} "
        f"ms/step mean; steps without a refresh median "
        f"{float(np.median(plain)):.4f} ms; refresh steps (eigh of every "
        f"factor, up to 2048 x 2048) {[round(x, 4) for x in refresh]} ms; "
        f"loss after {NG_STEPS} steps {float(nrun['loss']):.4f} | card: {card}")
    f32_step = make_train_step(tdnn, opt)
    frun = {"p": init, "s": opt.init(init)}
    f32_ms = [_event_ms(lambda: frun.update(zip(
        ("p", "s", "loss", "acc"),
        f32_step(frun["p"], frun["s"], feats, tgt, w))), 1) for _ in range(2)]
    log(f"  one f32 train step (TF32 off): {f32_ms[1]:.4f} ms (first call "
        f"{f32_ms[0]:.4f} ms), {flops / f32_ms[1] / 1e9:.2f} TFLOP/s; the "
        f"FP32 bound {flops / FP32_FLOP_PER_S * 1e3:.4f} ms | card: {card}")
    return {"tdnn": tdnn, "waves": waves_all, "segs": segs, "ref": ref_all,
            "loss": loss, "acc": acc, "t_train": t_train, "ms": ms}


def phase_lattice_full(tg, sl: dict, tr: dict, card: str) -> dict:
    import copy
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                                  CsrBeamDecoder, CsrBeamOpts)
    from kaldi_tpu_torch.lat import native_gen
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.generate import (decode_to_lattices,
                                              decode_to_lattices_stream,
                                              raw_lattice_from_decode)
    from kaldi_tpu_torch.recognize import Recognizer

    # the bench's 8 test utterances, decoded with the AM that the train
    # phase trained on its 16 training utterances
    graph, tdnn = sl["graph"], tr["tdnn"]
    search = dict(beam=13.0, max_active=7000, acoustic_scale=0.1,
                  expand_budget=16384, eps_budget=2048)
    rec = Recognizer(tdnn, graph, CsrBeamOpts(**search), device="cuda")
    waves = tr["waves"][TRAIN_UTTS:]
    answers = rec.recognize(waves)
    if any(a is None for a in answers):
        raise AssertionError("trained AM: an utterance has no best path")
    log(f"  trained AM (loss {tr['loss']:.4f}, frame accuracy "
        f"{tr['acc']:.4f}): best-path WER on the {TEST_UTTS} test "
        f"utterances {wer(tr['ref'][TRAIN_UTTS:], [a[0] for a in answers]):.2f}%")
    # the bench's latgen point (bench.py:415-425)
    t = time.perf_counter()
    dec = CsrBeamDecoder(graph, CsrBeamOpts(
        **search, rec_cap=3072, rec_beam=LATTICE_BEAM, rec_f16=True,
        rec_flat=True, rec_flat_cap=512), device="cuda")
    setup_s = time.perf_counter() - t
    ll_np = rec.loglikes(waves).float().cpu().numpy()   # bf16 TDNN's
    B, T, P = ll_np.shape
    nf = np.full(B, T, np.int32)
    audio = B * waves.shape[1] / 16000.0
    o = dec.opts
    R, Kc = 1 + int(o.eps_expansions), min(o.rec_cap, o.max_active)

    native_gen.extractions = 0
    t = time.perf_counter()
    list(decode_to_lattices_stream(dec, [(ll_np, nf)], LATTICE_BEAM,
                                   num_threads=8))
    warm_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tg.launches = 0                       # count the latgen path only
    fallbacks0 = dec.last_flat_fallbacks
    t = time.perf_counter()
    outs = list(decode_to_lattices_stream(
        dec, [(ll_np, nf)] * LATGEN_BATCHES, LATTICE_BEAM, num_threads=8))
    rate = LATGEN_BATCHES * audio / (time.perf_counter() - t)
    launches = tg.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches < 2 * T * LATGEN_BATCHES:
        raise AssertionError(f"{launches} gather launches for "
                             f"{LATGEN_BATCHES} batches of {T} frames")
    lats = outs[-1]
    if len(outs) != LATGEN_BATCHES:
        raise AssertionError(f"latgen: {len(outs)} batches came out")
    # one more batch, split by stage (host clock)
    t0 = time.perf_counter()
    fin = dec.decode_raw_async(ll_np, nf)
    t1 = time.perf_counter()
    raw = fin()
    t2 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as ex:
        lats1 = list(ex.map(lambda b: raw_lattice_from_decode(
            dec, raw, nf, b, LATTICE_BEAM), range(B)))
    t3 = time.perf_counter()
    if _sizes(lats1) != _sizes(lats):
        raise AssertionError("latgen: the split batch's lattices differ from "
                             "the stream's")
    shipped = B * T * R * Kc
    trunc = int(dec.last_rec_trunc.sum())
    wire = raw.get("rec_wire_slots", float("nan"))
    share = 100.0 * trunc / shipped
    log(f"  latgen: {rate:.3f} audio-sec/s over {LATGEN_BATCHES} batches x "
        f"{B} x {waves.shape[1] / 16000.0:.1f} s (decode_to_lattices_stream, "
        f"8 extraction threads; warm-up batch {warm_s:.3f} s, decoder set-up "
        f"{setup_s:.3f} s); gather launches {launches} "
        f"({launches / (LATGEN_BATCHES * T):.1f}/frame); peak device memory "
        f"{peak:.3f} GiB | card: {card}")
    log(f"  one batch: record decode enqueue {t1 - t0:.4f} s, device drain + "
        f"one copy + dense rebuild {t2 - t1:.4f} s, native extraction of "
        f"{B} utts on 8 threads {t3 - t2:.4f} s")
    log(f"  records: rec_trunc {trunc} of {shipped} shipped slots = "
        f"{share:.3f}% (bench.py:445 fails at 5%); rec_wire_slots "
        f"{wire} ({wire / (B * T * R):.1f}/frame; nan after a dense "
        f"fallback); flat fallbacks {dec.last_flat_fallbacks - fallbacks0} in "
        f"the timed runs, {dec.last_flat_fallbacks} in all; dense view width "
        f"{raw['states'].shape[-1]}; active tokens mean "
        f"{dec.last_active_sum.sum() / (B * T):.1f} peak "
        f"{int(dec.last_active_max.max())}; (lattice states, arcs) per utt "
        f"{_sizes(lats)} (None: no path survived the records)")
    failed = []
    if not share < 5.0:
        failed.append(f"record compaction truncated {share:.3f}% of shipped "
                      f"slots (rec_cap={Kc})")

    # untruncated records (bench.py:494-498), the same search: their
    # occupancy within rec_beam is what rec_cap cuts, so the capped run's
    # rec_trunc must be exactly its excess over Kc
    unc = copy.copy(dec)              # shares the tier tables
    unc.opts = dataclasses.replace(dec.opts, rec_cap=None,
                                   rec_flat_cap=1024)
    t = time.perf_counter()
    raw_u = unc.decode_raw(ll_np, nf)
    with ThreadPoolExecutor(max_workers=8) as ex:
        lats_u = list(ex.map(lambda b: raw_lattice_from_decode(
            unc, raw_u, nf, b, LATTICE_BEAM), range(B)))
    t_u = time.perf_counter() - t
    occ = np.sum(raw_u["scores"] < 5e9, axis=-1)          # [B, T, R]
    if not np.array_equal(np.maximum(occ - Kc, 0).sum(axis=(1, 2)),
                          dec.last_rec_trunc):
        failed.append("rec_trunc is not the untruncated records' excess "
                      "over rec_cap")
    # rec_beam may drop slots of the best path (ROADMAP §5): count the
    # lattices that still hold the decoder's best cost
    held = sum(lat is not None and abs(lattice_best_path(lat)[2] - want[2])
               <= 1e-3 * abs(want[2]) for lat, want in zip(lats_u, answers))
    log(f"  untruncated batch (rec_cap None, rec_flat_cap 1024): {t_u:.3f} "
        f"s, rec_trunc {int(unc.last_rec_trunc.sum())}, flat fallbacks "
        f"{unc.last_flat_fallbacks - dec.last_flat_fallbacks}; slots within "
        f"rec_beam per frame: mean {occ.mean():.1f}, p50 "
        f"{np.percentile(occ, 50):.0f}, p99 {np.percentile(occ, 99):.0f}, "
        f"max {occ.max()}, over rec_cap in {np.mean(occ > Kc):.4f} of frames, "
        f"their excess == rec_trunc exactly; lattices holding the "
        f"Recognizer's best cost {held}/{B}; (states, arcs) "
        f"{_sizes(lats_u)}")

    # records with nothing masked (rec_beam = beam, dense): every lattice's
    # best path is the decoder's, held against the bf16 Recognizer's words
    whole = copy.copy(dec)
    whole.opts = dataclasses.replace(dec.opts, rec_cap=None, rec_beam=None,
                                     rec_flat=False)
    t = time.perf_counter()
    lats_w = decode_to_lattices(whole, ll_np, nf, LATTICE_BEAM,
                                num_threads=8)
    t_w = time.perf_counter() - t
    ties = 0
    for b, (lat, want) in enumerate(zip(lats_w, answers)):
        if lat is None:
            failed.append(f"unmasked records, utt {b}: no lattice")
            continue
        got = lattice_best_path(lat)
        rel = abs(got[2] - want[2]) / max(abs(want[2]), 1e-9)
        if got[0] != want[0]:
            ties += 1
            log(f"  utt {b}: lattice best path differs from the Recognizer's "
                f"words: cost {got[2]:.6f} vs {want[2]:.6f} (rel {rel:.2e})")
        if rel > 1e-3:
            failed.append(f"unmasked records, utt {b}: lattice best cost "
                          f"{got[2]} vs the Recognizer's {want[2]}")
    log(f"  unmasked batch (rec_cap None, rec_beam = beam 13, dense): "
        f"{t_w:.3f} s; best paths of {B} lattices == the bf16 Recognizer's "
        f"words for {B - ties}/{B}, the rest ties within 1e-3; (states, "
        f"arcs) {_sizes(lats_w)}")

    # adaptive decode: a chunked small-frontier program, then escalation
    t = time.perf_counter()
    ad = AdaptiveCsrBeamDecoder(graph, CsrBeamOpts(**search),
                                small_max_active=1024, device="cuda")
    ad_setup = time.perf_counter() - t
    ll_dev = torch.as_tensor(ll_np, device="cuda")
    tg.launches = 0
    t = time.perf_counter()
    res_a = ad.decode(ll_dev, nf)
    t_a = time.perf_counter() - t
    a_launches = tg.launches
    t = time.perf_counter()
    res_f = ad.full.decode(ll_dev, nf)
    t_f = time.perf_counter() - t
    _same_results("adaptive full width", res_a, res_f, "adaptive")
    log(f"  adaptive (small_max_active 1024, 128-frame chunks): "
        f"{t_a:.4f} s against one full decode {t_f:.4f} s; escalated "
        f"{int(ad.last_escalated.sum())}/{B}, small chunks "
        f"{ad.last_small_chunks} of {-(-T // 128)}, gather launches "
        f"{a_launches}; set-up {ad_setup:.3f} s; words == full decode")
    if native_gen.extractions < B * (LATGEN_BATCHES + 4):
        failed.append(f"native extractor ran {native_gen.extractions} times")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": launches, "adaptive_launches": a_launches,
            "lats": lats, "lats_u": lats_u, "refs": tr["ref"][TRAIN_UTTS:],
            "waves": np.asarray(waves), "secs": waves.shape[1] / 16000.0}


# --------------------------------------------- the single-stream online path

ONLINE_FB = dict(samp_freq=16000.0, dither=0.0)
# phase 16: get_lattice on the first ONLINE_LATTICE_UTTS test utterances
# (1.5-1.8 s each on an NVIDIA H100 80GB HBM3 at 700 W; all 6 before,
# cut for the time limit)
ONLINE_LATTICE_UTTS = 2


def _online_fused_stream(fused, wave, chunk: int):
    fused.reset()
    for pos in range(0, len(wave), chunk):
        fused.accept_waveform(wave[pos:pos + chunk])
    fused.input_finished()
    return fused.best_path()


def _online_generic(am, dec, fb, wave, chunk: int, ivec=None, tm=None):
    """SingleUtteranceNnet2Decoder over OnlineMfcc(fbank) (+ i-vectors) on
    the decoder's device, fed `chunk` samples at a time."""
    from kaldi_tpu_torch.online.features import OnlineMfcc
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.ops.features import fbank
    pipe = OnlineNnet2FeaturePipeline(
        OnlineMfcc(fb, computer=fbank, device=dec.device), ivec)
    d = SingleUtteranceNnet2Decoder(am, tm or _TmShim, dec, pipe,
                                    chunk_frames=16, silence_phones={0})
    for pos in range(0, len(wave), chunk):
        d.pipeline.accept_waveform(wave[pos:pos + chunk])
        d.advance_decoding()
    d.finalize_decoding()
    return d.best_path()


class _TmShim:
    """scripts/bench_streaming.py:97-104: the online decoder needs only a
    phone per transition id for its trailing-silence checks."""

    @staticmethod
    def transition_id_to_phone(tid):
        return 0


class _TmMod3:
    """Phone = tid % 3, phone 0 silence: the i-vector's silence weighting
    then reweights some frames."""

    @staticmethod
    def transition_id_to_phone(tid):
        return int(tid) % 3


def phase_online_small():
    """Card vs CPU on small shapes: mfcc, plp and deltas; the padded
    BeamSearchDecoder; both FusedOnlineDecoder engines (and each stream vs
    the offline decode on the card); SingleUtteranceNnet2Decoder with
    i-vectors; the mixed-up AM's group sum (two card runs bit-equal, the
    card within 1e-6 relative of the CPU)."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.combine import sum_group_log_posteriors
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
    from kaldi_tpu_torch.online.ivector import (OnlineIvectorConfig,
                                                OnlineIvectorFeature)
    from kaldi_tpu_torch.ops.delta import add_deltas
    from kaldi_tpu_torch.ops.features import (MfccOpts, PlpOpts, fbank, mfcc,
                                              plp)
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.params import random_tdnn_params

    rng = np.random.default_rng(31)
    wave = torch.from_numpy(rng.standard_normal((2, 16000))
                            .astype(np.float32) * 1000)
    fo = FrameOpts(**ONLINE_FB)
    worst = 0.0
    for fn, opts in ((mfcc, MfccOpts(frame_opts=fo)),
                     (plp, PlpOpts(frame_opts=fo))):
        got, want = fn(wave.cuda(), opts), fn(wave, opts)
        for g, w in ((got, want), (add_deltas(got), add_deltas(want))):
            g = g.cpu()
            if not torch.allclose(g, w, rtol=2e-4, atol=2e-3):
                raise AssertionError(f"{fn.__name__}: card != CPU, max "
                                     f"{float((g - w).abs().max())}")
            worst = max(worst, float((g - w).abs().max()))
    log(f"  mfcc, plp and their deltas: card == CPU within rtol 2e-4 / "
        f"atol 2e-3 (max |diff| {worst:.3e})")

    su = small_stream_setup()
    fb = su["fb"]
    am = AmNnet(Tdnn(su["cfg"]).load_jax_params(su["params"]),
                priors=su["priors"])
    ll = (np.random.RandomState(3).randn(2, 40, 16) * 3).astype(np.float32)
    nf = np.array([40, 27], np.int32)
    bopts = BeamSearchOpts(beam=11.0, max_active=128, acoustic_scale=0.1)
    bd = {dev: BeamSearchDecoder(su["graph"], bopts, device=dev)
          for dev in ("cuda", "cpu")}
    _same_results("padded decode", bd["cuda"].decode(ll, nf),
                  bd["cpu"].decode(ll, nf), "cuda")
    rg, rc = bd["cuda"].decode_raw(ll, nf), bd["cpu"].decode_raw(ll, nf)
    for key in rc:
        if rc[key].dtype.kind != "f" and not np.array_equal(rg[key], rc[key]):
            raise AssertionError(f"padded decode_raw: {key} differs")
    log(f"  BeamSearchDecoder (padded, E = {bd['cuda'].E}): decode and "
        f"decode_raw's states equal on the card and the CPU")

    waves = [rng.standard_normal(n).astype(np.float32) * 4000
             for n in (9000, 23456, 17000)]
    for engine in ("padded", "csr"):
        res = {}
        for dev in ("cuda", "cpu"):
            dec = (BeamSearchDecoder(su["graph"], bopts, device=dev)
                   if engine == "padded"
                   else CsrBeamDecoder(su["graph"], su["opts"], device=dev))
            fused = FusedOnlineDecoder(am, dec, fb, t_max=256)
            res[dev] = [_online_fused_stream(fused, w, c)
                        for w, c in zip(waves, (2560, 1000, 7000))]
            if dev == "cuda":
                offline = _offline(am, dec, waves, fb)
        if any(r is None for r in res["cuda"]):
            raise AssertionError(f"fused {engine}: a stream has no "
                                 f"hypothesis")
        _same_results(f"fused {engine}", res["cuda"], res["cpu"], "cuda")
        _same_results(f"fused {engine}", res["cuda"], offline, "streamed")
        log(f"  FusedOnlineDecoder ({engine}), 3 streams fed 2560/1000/7000 "
            f"samples per call: card == CPU == offline decode on the card "
            f"(words, tids; cost within 1e-2); "
            f"{[len(r[0]) for r in res['cuda']]} words")

    ubm_frames = fbank(torch.from_numpy(waves[1]), fb).numpy()
    pick = np.random.default_rng(1).choice(len(ubm_frames), 4, replace=False)
    ubm = DiagGmm(np.full(4, 0.25), ubm_frames[pick],
                  np.tile(ubm_frames.var(axis=0) + 0.5, (4, 1)))
    ext = IvectorExtractor(ubm, 4, seed=1)
    ext.M *= 5.0
    icfg = dataclasses.replace(su["cfg"], feat_dim=28)
    iam_params = random_tdnn_params(icfg, np.random.default_rng(5))
    res = {}
    for dev in ("cuda", "cpu"):
        iam = AmNnet(Tdnn(icfg).load_jax_params(iam_params),
                     priors=su["priors"])
        dec = BeamSearchDecoder(su["graph"], bopts, device=dev)
        res[dev] = [_online_generic(
            iam, dec, fb, w, 1600, tm=_TmMod3,
            ivec=OnlineIvectorFeature(ext, OnlineIvectorConfig(
                num_gselect=3, silence_weight=0.1))) for w in waves[:2]]
    _same_results("nnet2 + i-vectors", res["cuda"], res["cpu"], "cuda")
    log(f"  SingleUtteranceNnet2Decoder with 4-dim online i-vectors, 2 "
        f"streams: card == CPU; {[len(r[0]) for r in res['cuda']]} words")

    gid = np.random.default_rng(4).permutation(np.repeat(np.arange(64), 3))
    mcfg = TdnnConfig(feat_dim=40, num_pdfs=192, hidden_dim=256,
                      nonlinearity="relu",
                      splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    mam = AmNnet(Tdnn(mcfg, device="cuda").load_jax_params(
        random_tdnn_params(mcfg, np.random.default_rng(3))), group_ids=gid)
    x = torch.from_numpy(rng.standard_normal((4, 300, 40))
                         .astype(np.float32)).cuda()
    a, b = mam.loglikes(x), mam.loglikes(x)
    if not torch.equal(a, b):
        raise AssertionError("mixed-up AM: two card runs differ")
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal(
        (4, 300, 192)).astype(np.float32)), dim=-1)
    got = sum_group_log_posteriors(lp.cuda(), gid, 64).cpu()
    want = sum_group_log_posteriors(lp, gid, 64)
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    if rel > 1e-6:
        raise AssertionError(f"group sum: card vs CPU {rel:.3e} relative")
    log(f"  mixed-up AM (192 rows -> 64 pdfs): two card runs bit-equal; "
        f"group sum card vs CPU {rel:.3e} relative (limit 1e-6)")


def _pcts(ms: list) -> tuple:
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 95))


def profile_online(what: str, wave, chunk: int, host_s_per_chunk: float,
                   feed):
    """Ten steady chunks of one stream (past its first four) under
    torch.profiler; `feed` takes a piece of the waveform."""
    feed(wave[:4 * chunk])
    n = 10
    busy, n_ops, by_name = device_time(
        lambda: [feed(wave[(4 + i) * chunk:(5 + i) * chunk])
                 for i in range(n)])
    log_profile(f"{what}, {n} chunks of one stream", "chunk", n, busy, n_ops,
                by_name, host_s_per_chunk, 12)


def phase_online_full(tg, card: str, profile: bool = False) -> dict:
    """scripts/bench_streaming.py's configuration on the card: 16 kHz,
    40-bin fbank, the 300-word HCLG, 18 x 6 s utterances, the relu TDNN of
    width 512 over 64 pdfs trained 300 bf16 steps with the port's train
    step, priors from alignment counts; the fused path (FusedOnlineDecoder
    on the CSR engine, keep_loglikes) over the 6 test utterances and the
    generic path (SingleUtteranceNnet2Decoder over OnlineMfcc(fbank), the
    padded decoder) over 3, each fed 160 ms per call, after a warm-up
    pass over one utterance; every hypothesis must equal the offline
    decode on the card and every lattice exist."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import fbank_targets, make_corpus
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)
    from kaldi_tpu_torch.online.features import OnlineMfcc
    from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.online.timing import OnlineTimer, OnlineTimingStats
    from kaldi_tpu_torch.ops.features import FbankOpts, fbank
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts

    SR, chunk = 16000.0, 2560
    n_train, n_test, T = 12, 6, 600
    fb = FbankOpts(frame_opts=FrameOpts(**ONLINE_FB),
                   mel_opts=MelOpts(num_bins=40))
    t = time.perf_counter()
    graph, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    waves, segs, _words = make_corpus(graph, n_train + n_test, T,
                                      np.random.default_rng(0), noise=0.25)
    with torch.no_grad():
        feats = fbank(torch.as_tensor(waves, device="cuda"), fb)
    Tf = feats.shape[1]
    tgt = np.stack([fbank_targets(s, Tf) for s in segs])
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=512,
                     pnorm_output_dim=128, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    tdnn = Tdnn(cfg, device="cuda")
    params = tdnn.init(torch.Generator(device="cuda").manual_seed(0))
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.02), 300)
    state = opt.init(params)
    step = make_train_step(tdnn, opt, compute_dtype=torch.bfloat16)
    tt = torch.as_tensor(tgt[:n_train, cfg.left_context:Tf - cfg.right_context],
                         device="cuda")
    wt = torch.ones(tt.shape, device="cuda")
    for _ in range(300):
        params, state, loss, acc = step(params, state, feats[:n_train], tt, wt)
    tdnn.load_state_dict(params)
    am = AmNnet(tdnn)
    am.set_priors_from_alignment_counts(
        np.bincount(tgt[:n_train].ravel(), minlength=64) + 1.0)
    t_setup = time.perf_counter() - t
    base_dec = BeamSearchDecoder(graph, BeamSearchOpts(
        beam=13.0, max_active=512, acoustic_scale=0.1), device="cuda")
    csr_opts = CsrBeamOpts(beam=13.0, max_active=512, acoustic_scale=0.1,
                           expand_budget=8192, eps_budget=1024)
    csr_dec = CsrBeamDecoder(graph, csr_opts, device="cuda")
    ll_off = am.loglikes(feats[n_train:])
    nf = np.full(n_test, Tf, np.int32)
    off, off_csr = base_dec.decode(ll_off, nf), csr_dec.decode(ll_off, nf)
    log(f"  graph {graph.num_states} states / {graph.num_arcs} arcs (max "
        f"out-degree {base_dec.E}); AM trained 300 bf16 steps on {n_train} x "
        f"{waves.shape[1] / SR:.2f} s: loss {float(loss):.4f}, frame "
        f"accuracy {float(acc):.4f}; set-up {t_setup:.3f} s | card: {card}")

    fused = FusedOnlineDecoder(am, csr_dec, fb, chunk_samples=chunk,
                               t_max=1024, keep_loglikes=True)
    for pass_ in range(2):                # pass 0 warms up on one utt
        if pass_ == 1:
            tg.launches = 0               # count the fused path only
        f_stats, f_lat, fin_ms, lat_ms, f_mism = OnlineTimingStats(), [], \
            [], [], 0
        lat_launches = 0
        for u in range(n_test if pass_ else 1):
            wave = waves[n_train + u]
            fused.reset()
            timer = OnlineTimer(f"u{u}")
            for pos in range(0, len(wave), chunk):
                t0 = time.perf_counter()
                fused.accept_waveform(wave[pos:pos + chunk])
                fused.sync()
                f_lat.append((time.perf_counter() - t0) * 1e3)
                timer.wait_until(min(pos + chunk, len(wave)) / SR)
            t0 = time.perf_counter()
            fused.input_finished()
            res = fused.best_path()
            fin_ms.append((time.perf_counter() - t0) * 1e3)
            timer.finish(f_stats)
            if res is None or list(res[0]) != list(off_csr[u][0]):
                f_mism += 1
            if u >= ONLINE_LATTICE_UTTS:
                continue
            t0, n0 = time.perf_counter(), tg.launches
            lat = fused.get_lattice(8.0)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            lat_launches += tg.launches - n0
            if lat is None:
                f_mism += 1
    launches = tg.launches - lat_launches     # streaming only
    frames = n_test * Tf
    if launches < frames:
        raise AssertionError(f"{launches} gather launches for {frames} "
                             f"fused frames")
    fp50, fp95 = _pcts(f_lat)
    log(f"  fused path (CSR engine, B = 1): online RTF "
        f"{f_stats.real_time_factor:.4f} over {f_stats.total_audio:.2f} s "
        f"of audio ({n_test} utts); chunk latency (accept + sync, 160 ms "
        f"chunks) p50 {fp50:.3f} ms p95 {fp95:.3f} ms; finalize "
        f"(input_finished + best_path) median {np.median(fin_ms):.3f} ms; "
        f"get_lattice median {np.median(lat_ms):.3f} ms (first "
        f"{len(lat_ms)} utts); max delay "
        f"{f_stats.max_delay:.4f} s; hypothesis mismatches vs offline "
        f"{f_mism} (None lattices of those counted); gather launches "
        f"{launches} "
        f"streaming ({launches / frames:.2f}/frame) and {lat_launches} in "
        f"get_lattice's record decodes | card: {card}")
    if f_mism:
        raise AssertionError(f"fused path: {f_mism} mismatches")
    if profile:
        wave = waves[n_train]
        fused.reset()
        profile_online("fused path", wave, chunk, fp50 / 1e3,
                       fused.accept_waveform)

    def make_generic():
        return SingleUtteranceNnet2Decoder(
            am, _TmShim, base_dec, OnlineNnet2FeaturePipeline(
                OnlineMfcc(fb, computer=fbank, device="cuda")),
            chunk_frames=16)

    for pass_ in range(2):                # pass 0 warms up on one utt
        g_stats, g_lat, g_mism, generic = OnlineTimingStats(), [], 0, []
        for u in range(3 if pass_ else 1):
            wave = waves[n_train + u]
            d = make_generic()
            timer = OnlineTimer(f"u{u}")
            for pos in range(0, len(wave), chunk):
                t0 = time.perf_counter()
                d.pipeline.accept_waveform(wave[pos:pos + chunk])
                d.advance_decoding()
                torch.cuda.synchronize()
                g_lat.append((time.perf_counter() - t0) * 1e3)
                timer.wait_until(min(pos + chunk, len(wave)) / SR)
            d.finalize_decoding()
            timer.finish(g_stats)
            res = d.best_path()
            generic.append(res)
            if res is None or list(res[0]) != list(off[u][0]):
                g_mism += 1
    gp50, gp95 = _pcts(g_lat)
    log(f"  generic path (SingleUtteranceNnet2Decoder, padded engine at "
        f"E = {base_dec.E}, K = 512: {512 * base_dec.E} candidates per "
        f"emitting round): online RTF {g_stats.real_time_factor:.4f} over "
        f"{g_stats.total_audio:.2f} s (3 utts); chunk latency p50 "
        f"{gp50:.3f} ms p95 {gp95:.3f} ms; max delay "
        f"{g_stats.max_delay:.4f} s; hypothesis mismatches vs offline "
        f"{g_mism} | card: {card}")
    if g_mism:
        raise AssertionError(f"generic path: {g_mism} mismatches")
    if profile:
        d = make_generic()

        def feed(w):
            d.pipeline.accept_waveform(w)
            d.advance_decoding()
        profile_online("generic path", waves[n_train], chunk, gp50 / 1e3,
                       feed)

    # the gather kernel at the fused CSR path's B = 1 shapes
    shapes = csr_gather_shapes(csr_dec, 1, 64)
    times = gather_at_shapes(tg, shapes, "the fused path's", 3)
    # what phase 32 serves: the AM, the graph, the options, the test waves
    # with their offline CSR decodes and the generic path's results
    return {"launches": launches, "shape": shapes[0],
            "times": times[shapes[0]], "am": am, "graph": graph, "fb": fb,
            "csr_opts": csr_opts, "test_waves": list(waves[n_train:]),
            "offline": off_csr, "frames": Tf, "generic": generic,
            "make_generic": make_generic}


def csr_gather_shapes(dec, B: int, P: int) -> list:
    """The (B, P, N) of each gather that a frame of `dec` (a
    CsrBeamDecoder) makes at batch B over P pdfs (`_make_rounds`): the
    fused acoustic lookup of the two tier-A arcs per token and b_apr arcs
    per budgeted tier-B row, the tier-B rows' token scores, and the hub
    arcs' lookup where the hubs have no one-hot."""
    o, tabs = dec.opts, dec.tabs
    K = int(o.max_active)
    have_b = tabs.brow.shape[0] > 1
    cbr = -(-int(o.expand_budget) // tabs.b_apr)
    shapes = [(B, P, 2 * K + (tabs.b_apr * cbr if have_b else 0))]
    if have_b:
        shapes.append((B, K, cbr))
    if len(tabs.hub_bounds) > 1 and tabs.hub_onehot is None:
        shapes.append((B, P, int(tabs.hub_pdf.shape[0])))
    return shapes


def gather_at_shapes(tg, shapes, what: str, seed: int) -> dict:
    """The gather kernel against its plain version at each (B, P, N) of
    `shapes` (random tables, indices in range; bit-exact), and its device
    time beside the plain version's, torch.gather's and the bound. ->
    {shape: (ms, plain_ms, library_ms)}"""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    times = {}
    for (B, P, N) in shapes:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        if not torch.equal(tg.gather_cuda(tab, idx),
                           tg.batched_table_gather_ref(tab, idx)):
            raise AssertionError(f"gather != plain at {(B, P, N)}")
        il = idx.long()
        times[(B, P, N)] = (cuda_ms(lambda: tg.gather_cuda(tab, idx)),
                            cuda_ms(lambda: tg.batched_table_gather_ref(
                                tab, idx)),
                            cuda_ms(lambda: torch.gather(tab, 1, il)))
        k_ms, p_ms, l_ms = times[(B, P, N)]
        log(f"  gather at {what} shape tab [{B}, {P}] idx [{B}, {N}]: "
            f"bit-exact; kernel {k_ms:.6f} ms, plain version {p_ms:.6f} "
            f"ms, torch.gather {l_ms:.6f} ms, bound "
            f"{gather_bound_ms(B, P, N):.6f} ms by bytes")
    return times


GMM_TRAIN_UTTS, GMM_TEST_UTTS = 250, 50   # phase 18 (a)'s corpus
DENSE_B, DENSE_SECS = 128, 10.0            # bench.py's small-graph line


def _rel_err(got, want) -> float:
    """max |got - want| / max(|want|, 1), elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0),
                        initial=0.0))


def gmm_term_scale(am, feats) -> np.ndarray:
    """[..., T, P] the largest sum of absolute terms in the GEMM of any
    gaussian of each pdf, |[x, -x^2/2, 1]| @ |packed| in f64: an f32
    loglike can be off by some 1e-7 of it (the terms cancel), so card and
    CPU are held to a share of it."""
    packed, seg = am.pack()
    x = np.abs(np.asarray(feats, np.float64))
    aug = np.concatenate([x, 0.5 * x * x, np.ones(x.shape[:-1] + (1,))],
                         axis=-1)
    mag = aug @ np.abs(packed.astype(np.float64))
    starts = np.searchsorted(seg, np.arange(am.num_pdfs))
    return np.maximum.reduceat(mag, starts, axis=-1)


def _same_alignments(name: str, got: list, want: list):
    for b, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None) or (w is not None and (
                not np.array_equal(g[0], w[0]) or g[1] != w[1])):
            raise AssertionError(f"{name}: utterance {b} aligns differently")
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} results, {len(want)} wanted")


def _same_gmm_models(name: str, got, want, rel: float) -> float:
    """Weights and means within rel; each variance within rel of its
    second moment (var + mean^2: the variance's own cancellation)."""
    worst = 0.0
    for a, b in zip(want.am.pdfs, got.am.pdfs):
        if a.num_gauss != b.num_gauss:
            raise AssertionError(f"{name}: gaussian counts differ")
        worst = max(worst, _rel_err(b.weights, a.weights),
                    _rel_err(b.means, a.means),
                    float(np.max(np.abs(b.vars - a.vars)
                                 / (a.vars + a.means ** 2))))
    if not worst <= rel:
        raise AssertionError(f"{name}: parameters differ by {worst:.3e} "
                             f"(limit {rel})")
    return worst


def _gmm_corpus_small(name: str):
    """6 utterances of the yesno or rm-like corpus, features on the CPU."""
    rng = np.random.RandomState(5)
    if name == "yesno":
        words = [[str(rng.choice(["YES", "NO"]))
                  for _ in range(rng.randint(2, 5))] for _ in range(6)]
        waves = [yesno_synth(ws, rng) for ws in words]
    else:
        words, waves = zip(*rm_corpus(rng, 6))
    return [(f"u{i}", mfcc_deltas(w, "cpu"), list(ws))
            for i, (ws, w) in enumerate(zip(words, waves))]


def em_card_vs_cpu(name: str, models: dict, batch, feats, nf, opts, align,
                   target) -> tuple[float, float]:
    """One EM iteration of the same GMM-HMM on the card and on the CPU
    (`models` {"cpu": ..., "cuda": ...}): the loglikes, Viterbi alignments
    (or `align`, one per device, when given), statistics and update. The
    alignments must be identical; the updated parameters within 1e-5
    (`_same_gmm_models`); the loglikes and tot_like within 1e-5 of the sums
    of absolute GEMM terms behind them (`gmm_term_scale`). -> (parameter
    error, loglike error)."""
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.steps import mono
    scale = gmm_term_scale(models["cpu"].am, feats)
    real = np.arange(feats.shape[1])[None, :] < nf[:, None]
    ll_errs = []
    if align is None:
        lls = {d: m.am.loglikes(feats) for d, m in models.items()}
        ll_errs.append(float(np.max(np.abs(
            lls["cuda"].cpu().numpy() - lls["cpu"].numpy()) / scale)))
        align = {d: viterbi_align(batch, lls[d], nf, opts.acoustic_scale,
                                  device=d) for d in models}
        _same_alignments(f"{name}: viterbi_align", align["cuda"],
                         align["cpu"])
    accs = {}
    for d, md in models.items():
        acc, tc, _n = mono._accumulate(md, feats, nf, align[d])
        mono._update(md, acc, tc, opts, target)
        accs[d] = acc
    ll_errs.append(abs(accs["cuda"].tot_like - accs["cpu"].tot_like)
                   / float(scale.max(axis=-1)[real].sum()))
    err = _same_gmm_models(name, models["cuda"], models["cpu"], 1e-5)
    if not max(ll_errs) <= 1e-5:
        raise AssertionError(f"{name}: card vs CPU loglikes {max(ll_errs):.3e}"
                             f" of their GEMM terms' magnitude (limit 1e-5)")
    return err, max(ll_errs)


def phase_gmm_small():
    """Card vs CPU at small shapes: GMM log-likelihoods; equal and Viterbi
    alignment and one EM iteration on yesno and rm-like training graphs;
    the dense decoder's three forward paths and its hub branch;
    recipe-yesno on the card."""
    from kaldi_tpu_torch import cli
    from kaldi_tpu_torch.decoder.dense import (DenseDecoderOpts,
                                               DenseViterbiDecoder)
    from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
    from kaldi_tpu_torch.decoder.viterbi import equal_align, viterbi_align
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    from kaldi_tpu_torch.steps import mono

    rng = np.random.RandomState(0)
    counts = [1, 40] + [int(c) for c in rng.randint(1, 17, 61)]
    feats = (rng.randn(4, 300, 39) * 3.0).astype(np.float32)
    want = random_am(counts, 39, 1, "cpu").loglikes(feats).numpy()
    got = random_am(counts, 39, 1, "cuda").loglikes(feats).cpu().numpy()
    err = _rel_err(got, want)
    if not err <= 1e-5:
        raise AssertionError(f"GMM loglikes: card vs CPU {err:.3e}")
    log(f"  AmDiagGmm.loglikes [4, 300, 39] over {sum(counts)} gaussians in "
        f"{len(counts)} pdfs (1 to 40 each): card vs CPU {err:.3e} "
        f"(limit 1e-5)")

    for name, lex, arpa in (("yesno", YESNO_LEXICON, YESNO_ARPA),
                            ("rm-like", RM_LEXICON, rm_unigram_arpa())):
        utts = _gmm_corpus_small(name)
        fl = [f for _u, f, _w in utts]
        feats, nf = pad_batch(fl)
        lang = gmm_stack(lex, arpa)[0]
        models = {d: mono.flat_start(lang, fl, d) for d in ("cpu", "cuda")}
        m = models["cpu"]
        comp = TrainingGraphCompiler(m.lang, m.trans_model, m.ctx_dep, 1.0,
                                     0.1)
        batch = pack_graphs([comp.compile_transcript(w)
                             for _u, _f, w in utts],
                            m.trans_model.id2pdf_array)
        eq = {d: equal_align(batch, nf, device=d) for d in models}
        _same_alignments(f"{name} equal_align", eq["cuda"], eq["cpu"])
        errs, ll_errs = [], []
        for it in range(2):          # the equal-align pass, then one EM
            err, ll_err = em_card_vs_cpu(
                f"{name} EM iteration {it}", models, batch, feats, nf,
                mono.MonoTrainOpts(), eq if it == 0 else None,
                models["cpu"].am.total_gauss + 8 if it else None)
            errs.append(err)
            ll_errs.append(ll_err)
        log(f"  {name}: {len(utts)} training graphs ({batch.src.shape[1]} "
            f"arcs padded): equal_align and viterbi_align identical; one EM "
            f"iteration card vs CPU: parameters {max(errs):.3e}, loglikes "
            f"and tot_like {max(ll_errs):.3e} of their GEMM terms' "
            f"magnitude (limits 1e-5), {models['cuda'].am.total_gauss} "
            f"gaussians")

    def card_vs_cpu(what, graph, ll, nf, **opts):
        res = [DenseViterbiDecoder(graph, DenseDecoderOpts(**opts),
                                   device=d).decode(ll, nf)
               for d in ("cuda", "cpu")]
        worst = 0.0
        for b, (g, w) in enumerate(zip(*res)):
            if (g is None) != (w is None) or (w is not None and (
                    g[0] != w[0] or g[1] != w[1])):
                raise AssertionError(f"dense {what}: utterance {b} differs")
            if w is not None:
                worst = max(worst, abs(g[2] - w[2]) / max(abs(w[2]), 1.0))
        if not worst <= 1e-4:
            raise AssertionError(f"dense {what}: cost {worst:.3e}")
        log(f"  dense {what}: words and tids identical, cost {worst:.3e} "
            f"(limit 1e-4)")

    rng = np.random.RandomState(1)
    nf = np.array([120, 97, 64], np.int32)
    _l, _c, tm_y, yes = gmm_stack(YESNO_LEXICON, YESNO_ARPA)
    _l, _c, tm_r, rm = gmm_stack(RM_LEXICON, rm_unigram_arpa())
    for what, graph, P, opts in (
            ("assoc (yesno, 17 states)", yes, tm_y.num_pdfs, {}),
            ("sequential (rm-like, 86 states)", rm, tm_r.num_pdfs, {}),
            ("checkpointed (rm-like, chunk 16)", rm, tm_r.num_pdfs,
             dict(traceback_chunk=16))):
        ll = (rng.randn(3, 120, P) * 5.0).astype(np.float32)
        card_vs_cpu(what, graph, ll, nf, **opts)
    card_vs_cpu("hub branch (in-degree 101), integer ties",
                dense_hub_graph(), rng.randint(-20, 1, (3, 40, 7)).astype(
                    np.float32), np.array([40, 33, 12], np.int32),
                acoustic_scale=1.0)

    t = time.perf_counter()
    cli.main(["recipe-yesno"])               # exits non-zero unless WER 0
    log(f"  recipe-yesno on the card: WER 0 in "
        f"{time.perf_counter() - t:.3f} s")


def _pipelined(launch, audio_s: float, n_iter: int = 8):
    """bench.py's serving loop: a warm-up, then n_iter launches, each
    finishing the one before. -> (audio-sec/s, s per launch, results of
    the last)."""
    launch()()
    t0 = time.perf_counter()
    pending = launch()
    for _ in range(n_iter - 1):
        nxt = launch()
        pending()
        pending = nxt
    out = pending()
    dt = (time.perf_counter() - t0) / n_iter
    return audio_s / dt, dt, out


def phase_gmm_full(tr: dict, card: str, profile: bool = False) -> dict:
    """(a) Flat-start monophone training at steps/train_mono.sh's defaults
    on the rm-like corpus, decoded through make_decoder; (b) bench.py's
    small-graph serving line (yesno HCLG, dense assoc path, phase 13's
    AM); (c) the same shape through the rm-like HCLG's sequential path
    from the GMM's log-likelihoods."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchOpts
    from kaldi_tpu_torch.decoder.dense import DenseViterbiDecoder, make_decoder
    from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.ops.features import cmvn, fbank
    from kaldi_tpu_torch.recognize import SERVING_FBANK
    from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono

    q.launches = tg.launches = 0              # count the GMM path only
    t0 = time.perf_counter()
    rng = np.random.RandomState(17)
    train = rm_corpus(rng, GMM_TRAIN_UTTS)
    test = rm_corpus(rng, GMM_TEST_UTTS)
    t = time.perf_counter()
    utts = [(f"tr{i}", mfcc_deltas(w, "cuda"), ws)
            for i, (ws, w) in enumerate(train)]
    test_feats, test_nf = pad_batch([mfcc_deltas(w, "cuda")
                                     for _ws, w in test])
    t_feat = time.perf_counter() - t
    lang, _ctx, _tm, _g = gmm_stack(RM_LEXICON, rm_unigram_arpa())
    opts = MonoTrainOpts()
    stats: list = []
    t = time.perf_counter()
    model = train_mono(lang, utts, opts, device="cuda", iter_stats=stats)
    t_train = time.perf_counter() - t
    n_frames = sum(f.shape[0] for _u, f, _w in utts)
    log(f"  (a) corpus: {GMM_TRAIN_UTTS} training utterances "
        f"({n_frames} frames, {n_frames / 100:.1f} s), {GMM_TEST_UTTS} "
        f"test; 39-dim MFCC + deltas on the card in {t_feat:.3f} s")
    for st in stats:
        log("    iter %2d: %s; aligned %d, loglike/frame %.4f" % (
            st["iter"], ", ".join(
                f"{k} {st[k] * 1e3:.2f} ms" for k in
                ("loglikes", "align", "accumulate", "update") if k in st),
            st["aligned"], st["loglike_per_frame"]))
    per = {k: [st[k] * 1e3 for st in stats if k in st]
           for k in ("loglikes", "align", "accumulate", "update")}
    packed = gmm_hclg(lang, rm_unigram_arpa(), model.trans_model,
                      model.ctx_dep)
    dec = make_decoder(packed, BeamSearchOpts(beam=14.0, max_active=1024,
                                              acoustic_scale=0.1),
                       device="cuda")
    res = dec.decode(model.am.loglikes(test_feats), test_nf)
    hyps = [[lang.words.sym(w) for w in r[0]] if r else [] for r in res]
    corpus_wer = wer([ws for ws, _w in test], hyps)
    log(f"  (a) train_mono({opts.num_iters} iterations, totgauss "
        f"{opts.totgauss}, {len(opts.realign_iters)} realignments): "
        f"{t_train:.3f} s; mean ms per iteration: " + ", ".join(
            f"{k} {np.mean(v):.2f} (x{len(v)})" for k, v in per.items())
        + f"; final loglike/frame {stats[-1]['loglike_per_frame']:.4f}; "
        f"total_gauss {model.am.total_gauss}; HCLG {packed.num_states} "
        f"states, {packed.num_arcs} arcs; test WER {corpus_wer:.2f}% "
        f"(limit 12.00) through {type(dec).__name__} | card: {card}")
    if not corpus_wer <= 12.0:
        raise AssertionError(f"mono WER {corpus_wer:.2f} > 12.00")

    # (b) bench.py:75-118: the yesno HCLG, 128 x 10 s of seeded noise
    # through the bench's AM (phase 13's), sliced to the graph's pdfs
    lang_y, _c, tm_y, yes = gmm_stack(YESNO_LEXICON, YESNO_ARPA)
    dec_y = make_decoder(yes, BeamSearchOpts(beam=16.0, max_active=128,
                                             acoustic_scale=0.1),
                         device="cuda")
    if not (isinstance(dec_y, DenseViterbiDecoder)
            and yes.num_states <= dec_y.opts.assoc_max_states):
        raise AssertionError(f"toy line: make_decoder picked {dec_y}")
    waves = torch.as_tensor((np.random.RandomState(0).randn(
        DENSE_B, int(16000 * DENSE_SECS)) * 1000).astype(np.float32),
        device="cuda")
    tdnn = tr["tdnn"].eval()

    def am_apply():
        with torch.inference_mode():
            return tdnn(cmvn(fbank(waves, SERVING_FBANK)), pad_context=True,
                        compute_dtype=torch.bfloat16)

    nf_b = np.full(DENSE_B, am_apply().shape[1], np.int32)

    def launch_b():
        return dec_y.decode_async(am_apply()[..., :tm_y.num_pdfs], nf_b)

    rate_b, dt_b, out_b = _pipelined(launch_b, DENSE_B * DENSE_SECS)
    if any(r is None for r in out_b):
        raise AssertionError("toy line: an utterance has no path")
    log(f"  (b) small-graph serving line: yesno HCLG {yes.num_states} "
        f"states, {yes.num_arcs} arcs, {tm_y.num_pdfs} pdfs -> "
        f"DenseViterbiDecoder, associative-scan path (S <= "
        f"{dec_y.opts.assoc_max_states}), {dec_y.opts.eps_expansions} eps "
        f"round(s); B = {DENSE_B} x {DENSE_SECS:.0f} s ({nf_b[0]} frames) "
        f"through fbank + CMVN + bf16 TDNN: {dt_b * 1e3:.3f} ms per launch, "
        f"{rate_b:.1f} audio-sec/s | card: {card}")

    # (c) the same shape through the rm-like HCLG's sequential path
    rng = np.random.RandomState(18)
    long = rm_corpus(rng, DENSE_B, 25, 26)
    feats_c, nf_c = pad_batch([mfcc_deltas(w, "cuda") for _ws, w in long])
    feats_c = torch.as_tensor(feats_c, device="cuda")
    audio_c = sum(len(w) for _ws, w in long) / GMM_SR
    if dec.graph.num_states <= dec.opts.assoc_max_states:
        raise AssertionError("rm-like HCLG should take the sequential path")

    def launch_c():
        return dec.decode_async(model.am.loglikes(feats_c), nf_c)

    rate_c, dt_c, out_c = _pipelined(launch_c, audio_c)
    long_wer = wer([ws for ws, _w in long],
                   [[lang.words.sym(w) for w in r[0]] if r else []
                    for r in out_c])
    log(f"  (c) rm-like HCLG ({packed.num_states} states) -> "
        f"DenseViterbiDecoder, sequential path, {dec.opts.eps_expansions} "
        f"eps round(s); B = {DENSE_B} x {audio_c / DENSE_B:.2f} s mean "
        f"({feats_c.shape[1]} frames padded) of 25-word utterances from the "
        f"GMM's loglikes: {dt_c * 1e3:.3f} ms per launch, {rate_c:.1f} "
        f"audio-sec/s; WER {long_wer:.2f}% | card: {card}")
    if tg.launches or q.launches:
        raise AssertionError(f"the GMM path launched gather {tg.launches} "
                             f"and qaffine {q.launches} times")
    log(f"  launches on the GMM path: gather {tg.launches}, qaffine "
        f"{q.launches}; phase 18 took {time.perf_counter() - t0:.3f} s")

    if profile:
        comp = TrainingGraphCompiler(lang, model.trans_model, model.ctx_dep,
                                     opts.transition_scale,
                                     opts.self_loop_scale)
        batch = pack_graphs([comp.compile_transcript(w)
                             for _u, _f, w in utts],
                            model.trans_model.id2pdf_array)
        feats_a, nf_a = pad_batch([f for _u, f, _w in utts])
        ll_a = model.am.loglikes(feats_a)

        def align():
            viterbi_align(batch, ll_a, nf_a, opts.acoustic_scale,
                          device="cuda")

        torch.cuda.synchronize()
        t = time.perf_counter()
        align()
        host_a = time.perf_counter() - t
        for what, fn, host_s in (
                (f"(a) viterbi_align of {GMM_TRAIN_UTTS} utterances, "
                 f"{ll_a.shape[1]} frames", align, host_a),
                ("(b) one toy-line launch + finish", lambda: launch_b()(),
                 dt_b),
                ("(c) one rm-like launch + finish", lambda: launch_c()(),
                 dt_c)):
            busy, n_ops, by_name = device_time(fn)
            log_profile(what, "call", 1, busy, n_ops, by_name, host_s, 12)
    return {"rate_toy": rate_b, "rate_rm": rate_c, "wer": corpus_wer}


# the triphone ladder's small checks (phase 19): test_triphone_e2e.py's
# options on its corpus
TRI_MONO = dict(num_iters=10, totgauss=40, max_iter_inc=6,
                realign_iters=tuple(range(1, 10)))
TRI_SMALL = dict(num_iters=15, totgauss=100, max_iter_inc=10, num_leaves=25,
                 tree_thresh=20.0, realign_iters=(2, 4, 6, 8, 10, 12))


def gmm_model_on(model, device):
    """A copy of a GMM-HMM `MonoModel` with its AmDiagGmm on `device` and
    a transition model of its own (EM updates both in place)."""
    import copy
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.steps.mono import MonoModel
    return MonoModel(AmDiagGmm([p.copy() for p in model.am.pdfs], device),
                     copy.deepcopy(model.trans_model), model.ctx_dep,
                     model.lang)


def trees_equal(a, b) -> bool:
    """Two event maps node for node: kinds, keys, question sets, table
    orders and answers."""
    kind = type(a).__name__
    if kind != type(b).__name__:
        return False
    if kind == "ConstantEventMap":
        return a.answer == b.answer
    if kind == "TableEventMap":
        return (a.key == b.key and list(a.table) == list(b.table)
                and all(trees_equal(a.table[v], b.table[v]) for v in a.table))
    return (a.key == b.key and a.yes_set == b.yes_set
            and trees_equal(a.yes, b.yes) and trees_equal(a.no, b.no))


def affine_term_scale(x, W) -> np.ndarray:
    """|x| @ |A|^T + |b| in f64: the sum of the absolute terms behind each
    output of the affine map W = [A, b] (an f32 product can be off by some
    1e-7 of it, in an order that differs between devices)."""
    W = np.abs(np.asarray(W, np.float64))
    return np.abs(np.asarray(x, np.float64)) @ W[:, :-1].T + W[:, -1]


def _aligned_mask(am, pdfs) -> np.ndarray:
    """[T, G] 1.0 where gaussian g belongs to frame t's aligned pdf."""
    seg = np.repeat(np.arange(am.num_pdfs), [p.num_gauss for p in am.pdfs])
    return (seg[None, :] == np.asarray(pdfs)[:, None]).astype(np.float64)


def fmllr_term_scale(am, feats, pdfs, post=None):
    """The fMLLR statistics (K, G) of `feats` aligned to `pdfs` with each
    term's absolute value, every gaussian of the frame's pdf weighted by
    `post` [T, G] (by default 1): the scale of the card-vs-CPU errors of
    `FmllrStats`, or with `post` a bound on the posteriors' difference,
    the bound that sets on them."""
    from kaldi_tpu_torch.transform.fmllr import FmllrStats
    means = np.concatenate([p.means for p in am.pdfs])
    variances = np.concatenate([p.vars for p in am.pdfs])
    st = FmllrStats(am.dim)
    st.accumulate(np.abs(np.asarray(feats, np.float64)), np.abs(means),
                  variances, _aligned_mask(am, pdfs) if post is None
                  else post)
    return st


def mllt_term_scale(am, feats, pdfs, post=None) -> np.ndarray:
    """MLLT's G of `feats` aligned to `pdfs` with |x - mu| in place of
    x - mu, every gaussian of the frame's pdf weighted by `post` [T, G]
    (by default 1)."""
    means = np.concatenate([p.means for p in am.pdfs])
    variances = np.concatenate([p.vars for p in am.pdfs])
    w = _aligned_mask(am, pdfs) if post is None else post
    x = np.asarray(feats, np.float64)
    G = np.zeros((x.shape[1],) * 3)
    for m in np.flatnonzero(w.sum(axis=0)):
        d = np.abs(x - means[m])
        G += ((d * w[:, m, None]).T @ d)[None] / variances[m][:, None, None]
    return G


def _worst(got, want, scale) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))
                        / np.maximum(scale, 1e-300)))


F32_EPS = 2.0 ** -24                      # f32 unit roundoff


def posterior_bound(am_cpu, am_card, feats, pdfs) -> dict:
    """The gaussian posteriors of `feats` within each frame's aligned pdf
    (`_posteriors_np`, as the statistics use them) on the card and on the
    CPU, and the bound that the per-gaussian loglikes' difference sets on
    their difference.

    With delta_tm the card's loglike of gaussian m at frame t less the
    CPU's, the exact softmax moves each posterior gamma (the CPU's) to
    gamma e^delta_tm / sum_m' gamma_m' e^delta_tm' (`softmax_shift_bound`):
    0 for a pdf of one gaussian. Each side's f32 softmax adds at most
    (|l - max l| + n + 3) eps of gamma (the subtraction, exp to 2 ulp, a
    sum of n terms, the division); 2^-126 covers denormals. -> {"bound" [T, G], "bound_mllt" (the same, plus the
    whole term of a gaussian whose occupancy straddles MlltStats'
    1e-8 cut), "card", "cpu" [T, G], "ll" (the loglikes' largest
    difference over their GEMM terms' magnitude), "spread" (max S_t)}."""
    import torch
    from kaldi_tpu_torch.gmm.am_gmm import _augment
    from kaldi_tpu_torch.transform.fmllr import _posteriors_np
    x = np.asarray(feats, np.float32)
    pdfs = np.asarray(pdfs)
    comp, post = {}, {}
    for d, am in (("cpu", am_cpu), ("card", am_card)):
        packed = am.device_pack()[0]
        comp[d] = torch.matmul(_augment(torch.as_tensor(x, device=am.device)),
                               packed).cpu().numpy().astype(np.float64)
        post[d] = _posteriors_np(am, x, pdfs, np.ones(len(x), np.float32))
    mask = _aligned_mask(am_cpu, pdfs) > 0
    xa = np.abs(x.astype(np.float64))
    terms = np.concatenate([xa, 0.5 * xa * xa, np.ones((len(x), 1))],
                           axis=1) @ np.abs(am_cpu.pack()[0].astype(np.float64))
    bound, spread = softmax_shift_bound(comp["cpu"], comp["card"], post["cpu"],
                                        mask)
    g = post["cpu"]
    straddle = ((g.sum(axis=0) < 1e-8) != (post["card"].sum(axis=0) < 1e-8))
    bound_mllt = bound + np.where(straddle[None, :],
                                  np.maximum(g, post["card"]), 0.0)
    delta = comp["card"] - comp["cpu"]
    return {"bound": bound, "bound_mllt": bound_mllt, "card": post["card"],
            "cpu": g, "spread": spread,
            "ll": float(np.max(np.abs(delta)[mask] / terms[mask],
                               initial=0.0))}


def softmax_shift_bound(comp_a, comp_b, post_a, mask, eps=None) -> tuple:
    """`posterior_bound` on arrays: component loglikes [N, G] of one side
    (a) and the other (b), a's posteriors within each row's masked
    gaussians, the mask [N, G], each side's unit roundoff eps (f32 by
    default). -> (bound [N, G] on |post_b - post_a|, the largest spread
    S_n).

    The softmax's exact response to the loglikes' difference delta moves a
    posterior p_i to p_i e^delta_i / sum_j p_j e^delta_j, so by
    p_i |e^delta_i / sum_j p_j e^delta_j - 1|, evaluated in f64 (delta
    taken less its row's largest, which cancels); each side's f32 softmax
    adds at most (|l - max l| + n + 3) eps of p, and 2^-126 covers
    denormals. (The first-order g (1 - g) S e^S majorises the response but
    lets through a change of the statistics' own terms when S is large.)"""
    delta = comp_b - comp_a
    dmax = np.where(mask, delta, -np.inf).max(axis=1, keepdims=True)
    spread = dmax - np.where(mask, delta, np.inf).min(axis=1, keepdims=True)
    spread = np.where(np.isfinite(spread), spread, 0.0)
    g = post_a
    e = np.where(mask, np.exp(np.where(mask, delta - np.where(
        np.isfinite(dmax), dmax, 0.0), 0.0)), 0.0)
    z = np.maximum((g * e).sum(axis=1, keepdims=True), 1e-300)
    la = np.where(mask, comp_a, -np.inf)
    dist = np.where(mask, la.max(axis=1, keepdims=True) - la, 0.0)
    n = mask.sum(axis=1, keepdims=True)
    u = F32_EPS if eps is None else eps
    bound = np.where(mask, g * np.abs(e / z - 1.0)
                     + 2.0 * (dist + n + 3) * u * g + 2.0 ** -126, 0.0)
    return bound, float(spread.max(initial=0.0))


def posterior_stats_card_vs_cpu(am_cpu, am_card, ali) -> tuple[dict, dict]:
    """`FmllrStats` and `MlltStats` of the aligned utterances `ali` [(feats,
    pdfs)], accumulated once with the card's AM and once with the CPU's:
    their only device work is the gaussian posteriors. -> ({"cpu":
    (FmllrStats, MlltStats), "cuda": ...}, errs), errs naming for fMLLR's
    K, G and beta and MLLT's G the largest difference over the terms'
    magnitude ("terms") and over the bound the posteriors' bound sets
    ("bound", must be <= 1); and for the posteriors the largest ratio of
    their difference to their bound ("posterior ratio", <= 1), the largest
    difference ("shift"), the CPU's posterior there ("at gamma"), the
    loglikes' largest spread S_t ("spread") and difference over their
    GEMM terms ("ll")."""
    from kaldi_tpu_torch.steps.lda_mllt import accumulate_mllt_from_alignment
    from kaldi_tpu_torch.transform.fmllr import FmllrStats
    from kaldi_tpu_torch.transform.mllt import MlltStats
    D = am_cpu.dim
    stats = {d: (FmllrStats(D), MlltStats(D)) for d in ("cpu", "cuda")}
    f_scale, f_bound = FmllrStats(D), FmllrStats(D)
    g_scale, g_bound = np.zeros((D, D, D)), np.zeros((D, D, D))
    errs = {"posterior ratio": 0.0, "shift": 0.0, "at gamma": 0.0,
            "spread": 0.0, "ll": 0.0}
    for feats, pdfs in ali:
        for d, am in (("cpu", am_cpu), ("cuda", am_card)):
            stats[d][0].accumulate_from_alignment(am, feats, pdfs)
            accumulate_mllt_from_alignment(am, feats, pdfs, stats[d][1])
        pb = posterior_bound(am_cpu, am_card, feats, pdfs)
        f_scale.add(fmllr_term_scale(am_cpu, feats, pdfs))
        f_bound.add(fmllr_term_scale(am_cpu, feats, pdfs, pb["bound"]))
        g_scale += mllt_term_scale(am_cpu, feats, pdfs)
        g_bound += mllt_term_scale(am_cpu, feats, pdfs, pb["bound_mllt"])
        shift = np.abs(pb["card"] - pb["cpu"])
        at = np.unravel_index(np.argmax(shift), shift.shape)
        if shift[at] > errs["shift"]:
            errs["shift"], errs["at gamma"] = float(shift[at]), \
                float(pb["cpu"][at])
        errs["posterior ratio"] = max(errs["posterior ratio"],
                                      _worst(pb["card"], pb["cpu"],
                                             pb["bound"]))
        errs["spread"] = max(errs["spread"], pb["spread"])
        errs["ll"] = max(errs["ll"], pb["ll"])
    (cf, cm), (gf, gm) = stats["cpu"], stats["cuda"]
    for name, got, want, scale, bound in (
            ("fMLLR K", gf.K, cf.K, f_scale.K, f_bound.K),
            ("fMLLR G", gf.G, cf.G, f_scale.G, f_bound.G),
            ("fMLLR beta", gf.beta, cf.beta, f_scale.beta, f_bound.beta),
            ("MLLT G", gm.G, cm.G, g_scale, g_bound)):
        errs[name] = {"terms": _worst(got, want, scale),
                      "bound": _worst(got, want, bound)}
    return stats, errs


def check_posterior_stats(check, what: str, errs: dict) -> str:
    """Hold `posterior_stats_card_vs_cpu`'s errs to their limits: the
    loglikes within 1e-5 of their GEMM terms, the posteriors and every
    statistic within the bound. -> a line for the log."""
    check(f"{what}: loglikes card vs CPU", errs["ll"])
    check(f"{what}: posteriors over their bound", errs["posterior ratio"],
          1.0)
    stats = [k for k in errs if isinstance(errs[k], dict)]
    for k in stats:
        check(f"{what}: {k} over its bound", errs[k]["bound"], 1.0)
    return (", ".join(f"{k} {errs[k]['terms']:.3e} of its terms' magnitude "
                      f"({errs[k]['bound']:.3f} of its bound)" for k in stats)
            + f"; posteriors at most {errs['posterior ratio']:.3f} of their "
            f"bound, the largest shift {errs['shift']:.3e} at gamma "
            f"{errs['at gamma']:.4f}; loglikes {errs['ll']:.3e} of their GEMM "
            f"terms, spread within a pdf up to {errs['spread']:.3e} nats")


class _Limits:
    """Collects every check of a phase and raises once, at the end, with
    all that failed."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, what: str, err: float, lim: float = 1e-5) -> float:
        if not err <= lim:
            self.failed.append(f"{what}: {err:.3e} (limit {lim})")
        return err

    def require(self, what: str, ok: bool):
        if not ok:
            self.failed.append(what)

    def done(self, phase: str):
        if self.failed:
            raise AssertionError(f"{phase}: " + "; ".join(self.failed))


def ladder_decoder(model, arpa: str, opts, device, flat: bool = True,
                   hclg=None):
    """`model`'s HCLG over the ARPA LM, by the flat pipeline
    (make_hclg_flat, pack_graph_flat) or the object one (`ladder_hclg`, or
    `hclg` when the caller built it, then pack_graph), behind a
    `CsrBeamDecoder` on `device` -> (decoder, graph build seconds)."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    t = time.perf_counter()
    if flat and hclg is None:
        packed = ladder_packed(model, arpa)
    else:
        hclg = hclg or ladder_hclg(model, arpa)
        packed = pack_graph(hclg.fst, model.trans_model.id2pdf_array)
    return CsrBeamDecoder(packed, opts, device=device), \
        time.perf_counter() - t


def ladder_hclg(model, arpa: str):
    """`model`'s HCLG over the ARPA LM by the object pipeline (make_hclg)."""
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    g = arpa_to_g(ArpaLm.parse(arpa), model.lang.words)
    return make_hclg(model.lang, g, model.trans_model, model.ctx_dep,
                     self_loop_scale=0.1)


def _same_decodes(what: str, got: list, want: list, rel: float = 1e-4):
    """Identical words and tids, costs within rel."""
    for b, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None) or (w is not None and (
                list(g[0]) != list(w[0]) or list(g[1]) != list(w[1])
                or abs(g[2] - w[2]) > rel * max(abs(w[2]), 1.0))):
            raise AssertionError(f"{what}: utterance {b} decodes differently")


def phase_ladder_small():
    """Card vs CPU at tests/test_triphone_e2e.py's and test_sat_lda.py's
    sizes: the triphone tree, the first EM iteration from it, the N-phone
    graphs (object and flat pipelines decode alike), LDA and MLLT
    transforms from card and CPU statistics, fMLLR statistics and
    transforms, the affine transform, and decode_fmllr."""
    import copy

    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.ops.delta import splice_frames
    from kaldi_tpu_torch.steps import deltas, lda_mllt, mono, sat, tdnn
    from kaldi_tpu_torch.transform import fmllr, lda, mllt

    check = _Limits()
    # (a) the tree and train_deltas' first EM iteration
    t0 = time.perf_counter()
    rng = np.random.RandomState(11)
    train = tri_corpus(rng, 30, lambda w: mfcc_deltas(w, "cpu"))
    test = tri_corpus(rng, 8, lambda w: mfcc_deltas(w, "cpu"))
    lang = gmm_stack(TRI_LEXICON, TRI_ARPA)[0]
    mono_cpu = mono.train_mono(lang, train, mono.MonoTrainOpts(**TRI_MONO),
                               device="cpu")
    monos = {"cpu": mono_cpu, "cuda": gmm_model_on(mono_cpu, "cuda")}
    opts = deltas.DeltasTrainOpts(**TRI_SMALL)
    trees = {d: deltas.build_triphone_tree(lang, m, train, opts)
             for d, m in monos.items()}
    (cc, ctm, cls), (gc, gtm, gls) = trees["cpu"], trees["cuda"]
    if not (trees_equal(cc.event_map, gc.event_map)
            and np.array_equal(ctm.id2pdf_array, gtm.id2pdf_array)
            and all((a is None and b is None) or (
                a.count == b.count and np.array_equal(a.x, b.x)
                and np.array_equal(a.x2, b.x2)) for a, b in zip(cls, gls))):
        raise AssertionError("triphone tree: card and CPU differ")
    models = {d: mono.MonoModel(deltas.init_am_from_leaf_stats(cls, 39, d),
                                copy.deepcopy(ctm), cc, lang) for d in monos}
    batch, feats, nf = mono.compile_and_pad(lang, ctm, cc, train,
                                            opts.transition_scale,
                                            opts.self_loop_scale)
    # the first EM iteration from the tree's one-gaussian init (a later
    # one, after the split into near copies, moves posterior mass between
    # near-tied gaussians by the loglikes' f32 error: PERF.md)
    err, ll_err = em_card_vs_cpu("train_deltas EM iteration 1", models,
                                 batch, feats, nf, opts, None,
                                 models["cpu"].am.total_gauss + 40)
    log(f"  (a) tri corpus: {len(train)} utterances; tree from card and CPU "
        f"alignments identical ({cc.num_pdfs} leaves from "
        f"{mono_cpu.am.num_pdfs} monophone pdfs, leaf statistics equal); "
        f"train_deltas' first EM iteration card vs CPU: parameters "
        f"{err:.3e}, loglikes and tot_like {ll_err:.3e} of their GEMM "
        f"terms' magnitude (limits 1e-5), "
        f"{models['cuda'].am.total_gauss} gaussians")

    # (b) train_deltas on the card; its N-phone HCLG by both pipelines
    tri = deltas.train_deltas(lang, train, monos["cuda"], opts)
    copts = CsrBeamOpts(beam=200.0, max_active=512, acoustic_scale=0.1)
    tfeats, tnf = pad_batch([f for _u, f, _w in test])
    ll = tri.am.loglikes(tfeats)
    res = {}
    for flat in (True, False):
        dec, secs = ladder_decoder(tri, TRI_ARPA, copts, "cuda", flat)
        res[flat] = (dec.decode(ll, tnf), dec.graph.num_states, secs)
    _same_decodes("N-phone HCLG, flat vs object pipeline", res[True][0],
                  res[False][0])
    tri_wer = wer([w for _u, _f, w in test],
                  [[lang.words.sym(x) for x in r[0]] if r else []
                   for r in res[True][0]])
    check("train_deltas on the card: test WER", tri_wer, 0.0)
    log(f"  (b) train_deltas on the card: {tri.am.num_pdfs} leaves, "
        f"{tri.am.total_gauss} gaussians; N-phone HCLG by make_hclg_flat "
        f"({res[True][1]} states, {res[True][2]:.3f} s) and make_hclg "
        f"({res[False][1]} states, {res[False][2]:.3f} s) decode alike "
        f"through CsrBeamDecoder on the card; WER {tri_wer:.2f}")

    # (c) LDA and MLLT from card and CPU statistics
    ylang = gmm_stack(YESNO_LEXICON, YESNO_ARPA)[0]
    train_d, train_r, test_r = lda_corpus("cpu")
    ymono = mono.train_mono(ylang, train_d,
                            mono.MonoTrainOpts(**SAT_LDA_MONO), device="cpu")
    lopts = lda_mllt.LdaMlltTrainOpts(**LDA_SMALL)
    A, ali, spliced_err = {}, {}, 0.0
    for d in ("cpu", "cuda"):
        m = gmm_model_on(ymono, d)
        ali[d] = tdnn.align_with_gmm(m, train_d)
        st = lda.LdaStats(m.am.num_pdfs, 13 * 7)
        for (f, pdfs), (_u, raw, _w) in zip(ali[d], train_r):
            sp = splice_frames(torch.as_tensor(raw, device=d), 3, 3)
            spliced_err = max(spliced_err, float(np.max(np.abs(
                sp.cpu().numpy() - splice_frames(torch.as_tensor(raw), 3,
                                                 3).numpy()))))
            st.accumulate(sp.cpu().numpy()[: len(pdfs)], pdfs)
        A[d] = lda.estimate_lda(st, lopts.lda_dim)[0]
    check("splice on the card vs CPU", spliced_err, 0.0)
    check.require("yesno alignments: card and CPU differ", all(
        np.array_equal(a[1], b[1]) for a, b in zip(ali["cpu"], ali["cuda"])))
    lda_err = check("LDA card vs CPU", _worst(A["cuda"], A["cpu"],
                                              np.abs(A["cpu"]).max()))
    # MLLT's statistics from the card's and the CPU's posteriors on the
    # same alignments, held to the bound the loglikes' difference sets;
    # the solve is host f64 code, so the matrices differ only through them
    mstats, m_errs = posterior_stats_card_vs_cpu(
        gmm_model_on(ymono, "cpu").am, gmm_model_on(ymono, "cuda").am,
        ali["cpu"])
    m_line = check_posterior_stats(check, "LDA corpus", m_errs)
    M = {d: mllt.update_mllt(mstats[d][1])[0] for d in mstats}
    m_entry = _worst(M["cuda"], M["cpu"], np.abs(M["cpu"]).max())
    res_lda = lda_mllt.train_lda_mllt(ylang, train_d, train_r,
                                      gmm_model_on(ymono, "cuda"), lopts)
    lfeats, lnf = pad_batch([res_lda.transform_feats(f, lopts)
                             for _u, f, _w in test_r])
    dec, _s = ladder_decoder(res_lda.model, YESNO_ARPA, copts, "cuda")
    lda_wer = wer([w for _u, _f, w in test_r],
                  [[ylang.words.sym(x) for x in r[0]] if r else []
                   for r in dec.decode(res_lda.model.am.loglikes(lfeats),
                                       lnf)])
    check("train_lda_mllt on the card: test WER", lda_wer, 0.0)
    log(f"  (c) LDA+MLLT, yesno: splice and alignments identical; LDA from "
        f"card and CPU statistics {lda_err:.3e} of its largest entry "
        f"(limit 1e-5); posterior-fed statistics card vs CPU: {m_line} "
        f"(limits: 1 of each bound, 1e-5 for the loglikes); MLLT from each device's statistics (not limited: the "
        f"solve's conditioning) {m_entry:.3e} of its largest entry; "
        f"train_lda_mllt on the card: a {list(res_lda.transform.shape)} "
        f"transform, WER {lda_wer:.2f}")

    # (d) fMLLR statistics per speaker, transforms and decode_fmllr
    strain, stest, refs = sat_corpus("cpu")
    smono = mono.train_mono(ylang, [(u, f, w) for u, f, w, _s in strain],
                            mono.MonoTrainOpts(**SAT_LDA_MONO), device="cpu")
    ali = tdnn.align_with_gmm(smono, [(u, f, w) for u, f, w, _s in strain])
    spk = [s for _u, _f, _w, s in strain]
    am_c, am_g = gmm_model_on(smono, "cpu").am, gmm_model_on(smono, "cuda").am
    w_err = y_err = 0.0
    for s in sorted(set(spk)):
        fstats, f_errs = posterior_stats_card_vs_cpu(
            am_c, am_g, [a for a, s2 in zip(ali, spk) if s2 == s])
        f_line = check_posterior_stats(check, f"speaker {s}", f_errs)
        log(f"  (d) speaker {s}: {f_line}")
        W = {d: fmllr.estimate_fmllr(fstats[d][0], min_count=50.0)[0]
             for d in fstats}
        w_err = max(w_err, _worst(W["cuda"], W["cpu"],
                                  np.abs(W["cpu"]).max()))
        x = strain[spk.index(s)][1]
        y = {d: fmllr.apply_affine_transform(x, W["cpu"], d).cpu().numpy()
             for d in fstats}
        y_err = max(y_err, _worst(y["cuda"], y["cpu"],
                                  np.abs(y["cpu"]).max()))
    check("apply_affine_transform card vs CPU", y_err)
    sat_card = sat.train_sat(ylang, strain, gmm_model_on(smono, "cuda"),
                             sat.SatTrainOpts(**SAT_SMALL))
    sat_cpu = sat.SatModel(gmm_model_on(sat_card.model, "cpu"),
                           dict(sat_card.transforms))
    hyps = {}
    for d, model in (("cuda", sat_card), ("cpu", sat_cpu)):
        dec, _s = ladder_decoder(model.model, YESNO_ARPA, copts, d)
        hyps[d] = sat.decode_fmllr(model, dec, stest, ylang,
                                   fmllr_min_count=50.0)
    check("decode_fmllr: utterances whose words differ on card and CPU",
          sum(hyps["cuda"][u] != hyps["cpu"][u] for u in hyps["cpu"]), 0)
    want = [refs[u] for u, _f, _s in stest]
    sat_wer = wer(want, [[ylang.words.sym(x) for x in hyps["cuda"][u]]
                         for u, _f, _s in stest])
    sfeats, snf = pad_batch([f for _u, f, _s in stest])
    dec, _s = ladder_decoder(sat_card.model, YESNO_ARPA, copts, "cuda")
    si_wer = wer(want, [[ylang.words.sym(x) for x in r[0]] if r else []
                        for r in dec.decode(sat_card.model.am.loglikes(sfeats),
                                            snf)])
    check.require(f"SAT WER {sat_wer:.2f} <= SI {si_wer:.2f} and < 25",
                  sat_wer <= si_wer and sat_wer < 25.0)
    log(f"  (d) fMLLR, 3 warped speakers: estimate_fmllr from each device's "
        f"statistics (not limited: the solve's conditioning) {w_err:.3e} of "
        f"its largest entry; apply_affine_transform {y_err:.3e} of its "
        f"largest entry (limit 1e-5); train_sat on the card: "
        f"{len(sat_card.transforms)} speaker transforms; decode_fmllr: the "
        f"same words on card and CPU; WER SAT {sat_wer:.2f}, SI "
        f"{si_wer:.2f} (SAT <= SI, SAT < 25); phase 19 took "
        f"{time.perf_counter() - t0:.3f} s")
    check.done("phase 19")


# the full ladder (phase 20): tests/test_ladder_full.py's options
LADDER_MONO = dict(num_iters=14, totgauss=500, max_iter_inc=10,
                   realign_iters=tuple(range(1, 14)))
LADDER_TRI = dict(num_iters=12, totgauss=1500, max_iter_inc=8,
                  num_leaves=200, realign_iters=(1, 2, 3, 4, 5, 6, 8, 10))
LADDER_LDA = dict(LADDER_TRI, lda_dim=30, mllt_iters=(2, 4, 6))
LADDER_TDNN = dict(hidden_dim=512, pnorm_output_dim=128, nonlinearity="relu",
                   splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
LADDER_NNET = dict(initial_lr=0.1, final_lr=0.01, num_epochs=14,
                   minibatch_size=256)
LADDER_DECODE = dict(beam=14.0, max_active=1024, acoustic_scale=0.1,
                     expand_budget=16384)
# PARITY.md's ladder row: strict rungs and absolute bars
LADDER_BARS = dict(mono=35.0, tri=12.0, lda=7.0, tdnn=7.0)


def ladder_feats(waves, deltas: bool, device, vtln_warp: float = 1.0) -> list:
    """tests/test_ladder_full.py `_featize_batch` on `device`: MFCC (with
    deltas if asked, the mel banks warped by vtln_warp) of the zero-padded
    batch, each cut to its own frames."""
    from kaldi_tpu_torch.ops.delta import add_deltas
    wb = np.zeros((len(waves), max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        wb[i, : len(w)] = w
    f = _mfcc(wb, device, vtln_warp)
    if deltas:
        f = add_deltas(f, order=2, window=2)
    fb = f.cpu().numpy()
    return [fb[i, : max(0, (len(w) - 200) // 80 + 1)]
            for i, w in enumerate(waves)]


def _iter_ms(stats: list) -> str:
    """Mean ms per iteration of each phase that iter_stats timed."""
    keys = [k for k in ("ubm", "denlats", "tree", "lda", "fmpe", "loglikes",
                        "align", "mllt", "fmllr", "boost", "rescore+fb",
                        "post", "accumulate", "step", "update")
            if any(k in s for s in stats)]
    return ", ".join(
        f"{k} {np.mean([s[k] for s in stats if k in s]) * 1e3:.1f} ms "
        f"(x{sum(k in s for s in stats)})" for k in keys)


def phase_ladder_full(card: str, profile: bool = False) -> dict:
    """tests/test_ladder_full.py on the card: mono -> tri -> LDA+MLLT ->
    TDNN on its 120-word, 5-speaker coarticulated corpus, each decoded
    through make_hclg_flat + CsrBeamDecoder; then SAT from tri with
    decode_fmllr. Asserts PARITY.md's rungs and bars and SAT <= SI."""
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.nnet.train import NnetTrainOpts
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.steps import deltas, lda_mllt, mono, sat, tdnn

    q.launches = tg.launches = 0          # count the ladder's path only
    t0 = time.perf_counter()
    corpus = ladder_corpus(**LADDER)
    t = time.perf_counter()
    tr_w = [w for _u, w, _ws, _s in corpus["train"]]
    te_w = [w for _u, w, _ws, _s in corpus["test"]]
    feats = {(part, d): ladder_feats(ws, d, "cuda")
             for part, ws in (("train", tr_w), ("test", te_w))
             for d in (True, False)}
    t_feat = time.perf_counter() - t
    train = {d: [(u, f, ws) for (u, _w, ws, _s), f
                 in zip(corpus["train"], feats["train", d])]
             for d in (True, False)}
    test = {d: [(u, f, ws) for (u, _w, ws, _s), f
                in zip(corpus["test"], feats["test", d])]
            for d in (True, False)}
    refs = [ws for _u, _w, ws, _s in corpus["test"]]
    lang = prepare_lang(Lexicon.parse(corpus["lex_text"]), ["SIL"], "SIL",
                        num_sil_states=3)
    V = corpus["words"]
    arpa = ("\\data\\\nngram 1=%d\n\n\\1-grams:\n%s\n-99\t<s>\n-1\t</s>\n"
            "\n\\end\\\n" % (len(V) + 2, "\n".join(
                f"-{np.log10(len(V)):.4f}\t{w}" for w in V)))
    n_frames = sum(f.shape[0] for _u, f, _w in train[True])
    log(f"  corpus: {len(train[True])} training utterances ({n_frames} "
        f"frames), {len(refs)} test, {len(V)} words over 30 phones, 5 "
        f"speakers; MFCC (+ deltas) on the card in {t_feat:.3f} s")
    dopts = CsrBeamOpts(**LADDER_DECODE)
    out, graph_s, shapes = {}, {}, set()

    def wer_of(name, model, test_utts, transform=None):
        from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
        t = time.perf_counter()
        packed = ladder_packed(model, arpa)
        dec = CsrBeamDecoder(packed, dopts, device="cuda")
        graph_s[name] = time.perf_counter() - t
        fl = [transform(f) if transform else f for _u, f, _w in test_utts]
        fb, nf = pad_batch(fl)
        ll = model.am.loglikes(fb)
        shapes.update(csr_gather_shapes(dec, ll.shape[0], ll.shape[2]))
        res = dec.decode(ll, nf)
        w = wer(refs, [[lang.words.sym(x) for x in r[0]] if r else []
                       for r in res])
        if name == "tri":                 # the CSR witness's batch
            save_witness(CSR_WITNESS, csr_witness_data(
                packed, ll, nf, dopts, res, dec.last_overflow))
        return w, dec.graph.num_states, time.perf_counter() - t

    def stage(name, train_fn, model_of, test_utts, transform_of=None):
        stats: list = []
        t = time.perf_counter()
        res = train_fn(stats)
        secs = time.perf_counter() - t
        model = model_of(res)
        w, states, dec_s = wer_of(name, model, test_utts,
                                  transform_of(res) if transform_of else None)
        gauss = getattr(model.am, "total_gauss", None)
        out[name] = dict(wer=w, secs=secs, leaves=model.am.num_pdfs,
                         gauss=gauss, stats=stats)
        log(f"  {name}: trained in {secs:.3f} s"
            + (f"; per iteration: {_iter_ms(stats)}" if stats else "")
            + f"; {model.am.num_pdfs} leaves"
            + (f", {gauss} gaussians" if gauss else "")
            + f"; HCLG {states} states built in {graph_s[name]:.3f} s; "
            f"decode {dec_s:.3f} s; test WER {w:.2f} | card: {card}")
        return res

    mono_m = stage("mono", lambda st: mono.train_mono(
        lang, train[True], mono.MonoTrainOpts(**LADDER_MONO),
        device="cuda", iter_stats=st), lambda r: r, test[True])
    tri = stage("tri", lambda st: deltas.train_deltas(
        lang, train[True], mono_m, deltas.DeltasTrainOpts(**LADDER_TRI),
        iter_stats=st), lambda r: r, test[True])
    lopts = lda_mllt.LdaMlltTrainOpts(**LADDER_LDA)
    lda = stage("lda_mllt", lambda st: lda_mllt.train_lda_mllt(
        lang, train[True], train[False], tri, lopts, iter_stats=st),
        lambda r: r.model, test[False],
        lambda r: lambda f: r.transform_feats(f, lopts))
    train_l = [(u, lda.transform_feats(f, lopts), ws)
               for u, f, ws in train[False]]
    test_l = [(u, lda.transform_feats(f, lopts), ws)
              for u, f, ws in test[False]]
    nnet = stage("tdnn", lambda st: tdnn.train_tdnn(
        lda.model, train_l, config=TdnnConfig(
            feat_dim=30, num_pdfs=0, **LADDER_TDNN),
        train_opts=NnetTrainOpts(**LADDER_NNET)),
        lambda r: mono.MonoModel(r.am, lda.model.trans_model,
                                 lda.model.ctx_dep, lang), test_l)
    hist = nnet.history
    log(f"  tdnn: {len(hist)} logged steps, loss {hist[0][2]:.4f} -> "
        f"{hist[-1][2]:.4f}, frame accuracy {hist[-1][3]:.4f}")
    w = {k: v["wer"] for k, v in out.items()}
    checks = [("tri < mono - 8", w["tri"] < w["mono"] - 8.0),
              ("lda <= tri", w["lda_mllt"] <= w["tri"]),
              ("tdnn <= lda + 1", w["tdnn"] <= w["lda_mllt"] + 1.0)] + [
        (f"{k} <= {b}", w["lda_mllt" if k == "lda" else k] <= b)
        for k, b in LADDER_BARS.items()]
    log("  LADDER: mono %.2f > tri %.2f > lda_mllt %.2f >= tdnn %.2f; "
        % (w["mono"], w["tri"], w["lda_mllt"], w["tdnn"])
        + ", ".join(f"{c} {'ok' if ok else 'FAILS'}" for c, ok in checks))
    failed = [c for c, ok in checks if not ok]
    if failed:
        raise AssertionError(f"ladder: {failed} fail (WERs {w})")

    # SAT from tri: the ladder's tri options, SatTrainOpts' fMLLR defaults
    spk_train = [(u, f, ws, s) for (u, f, ws), (_u, _w, _ws, s)
                 in zip(train[True], corpus["train"])]
    spk_test = [(u, f, s) for (u, f, _ws), (_u, _w, _w2, s)
                in zip(test[True], corpus["test"])]
    stats: list = []
    t = time.perf_counter()
    with SatWitness() as sw:
        sm = sat.train_sat(lang, spk_train, tri,
                           sat.SatTrainOpts(**LADDER_TRI), iter_stats=stats)
    sat_s = time.perf_counter() - t
    save_witness(SAT_WITNESS, sw.data)
    t = time.perf_counter()
    dec, graph_s["sat"] = ladder_decoder(sm.model, arpa, dopts, "cuda")
    hyps = sat.decode_fmllr(sm, dec, spk_test, lang)
    sat_dec_s = time.perf_counter() - t
    w_sat = wer(refs, [[lang.words.sym(x) for x in hyps[u]]
                       for u, _f, _s in spk_test])
    fb, nf = pad_batch([f for _u, f, _s in spk_test])
    ll = sm.model.am.loglikes(fb)
    shapes.update(csr_gather_shapes(dec, ll.shape[0], ll.shape[2]))
    w_si = wer(refs, [[lang.words.sym(x) for x in r[0]] if r else []
                      for r in dec.decode(ll, nf)])
    out["sat"] = dict(wer=w_sat, si_wer=w_si, secs=sat_s,
                      leaves=sm.model.am.num_pdfs,
                      gauss=sm.model.am.total_gauss, stats=stats)
    log(f"  sat: trained in {sat_s:.3f} s; per iteration: {_iter_ms(stats)}; "
        f"{len(sm.transforms)} speaker transforms, {sm.model.am.num_pdfs} "
        f"leaves, {sm.model.am.total_gauss} gaussians; decode_fmllr "
        f"{sat_dec_s:.3f} s (two passes); test WER SAT {w_sat:.2f}, the "
        f"same model unadapted (SI) {w_si:.2f}, tri {w['tri']:.2f} | "
        f"card: {card}")
    if not w_sat <= w_si:
        raise AssertionError(f"SAT {w_sat:.2f} > SI {w_si:.2f}")

    # the graph: object pipeline once, for the time beside the flat one's
    # (phase 22 takes this HCLG as bMMI's denominator graph)
    t = time.perf_counter()
    tri_hclg = ladder_hclg(tri, arpa)
    _dec, _s = ladder_decoder(tri, arpa, dopts, "cuda", hclg=tri_hclg)
    obj_s = time.perf_counter() - t
    log(f"  tri's HCLG: make_hclg_flat {graph_s['tri']:.3f} s, make_hclg "
        f"(object pipeline, Python compose_context) {obj_s:.3f} s")
    if q.launches:
        raise AssertionError(f"the ladder launched qaffine {q.launches} "
                             f"times")
    log(f"  launches on the ladder: gather {tg.launches} (its decodes), "
        f"qaffine {q.launches}; phase 20 took "
        f"{time.perf_counter() - t0:.3f} s")
    launches = tg.launches
    # the kernel at every shape the ladder's decodes gave it (these
    # launches come after the count was read)
    g_times = gather_at_shapes(tg, sorted(shapes), "the ladder's", 4)

    if profile:
        profile_ladder(tri, train[True])
    return dict(out, launches=launches, graph_s=graph_s, obj_graph_s=obj_s,
                gather_times=g_times, models=dict(
                    lang=lang, arpa=arpa, refs=refs, dopts=dopts, tri=tri,
                    tri_hclg=tri_hclg, lda=lda, nnet=nnet, train=train[True],
                    test=test[True],
                    train_l=train_l, test_l=test_l, train_raw=train[False],
                    test_raw=test[False], corpus=corpus, mono=mono_m))


def profile_ladder(model, utts):
    """One realignment of the training set with `model` and one
    per-utterance accumulation pass over it, under torch.profiler."""
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.steps import mono
    import torch
    batch, feats, nf = mono.compile_and_pad(model.lang, model.trans_model,
                                            model.ctx_dep, utts, 1.0, 0.1)
    ll = model.am.loglikes(feats)

    def align():
        return viterbi_align(batch, ll, nf, 0.1, device="cuda")

    ali = align()

    def accumulate():
        mono._accumulate(model, feats, nf, ali)

    for what, fn in (("realignment", align), ("accumulation", accumulate)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        busy, n_ops, by_name = device_time(fn)
        log_profile(f"tri {what} of {len(utts)} utterances", "call", 1,
                    busy, n_ops, by_name, host_s, 8)


# the discriminative path (phases 21-22): tests/test_discriminative.py's
# yesno system and tests/test_rm_like_recipe.py's, test_fmmi.py's and
# the ladder's options
MMI_MONO = dict(num_iters=8, totgauss=40, max_iter_inc=6,
                realign_iters=tuple(range(1, 8)))


def mmi_system(device) -> dict:
    """tests/test_discriminative.py's `mmi_system` (:138-167) built by the
    port on `device`: from RandomState(7), 16 training and then 6 test
    yesno utterances of 2-4 words (MFCC + deltas), a monophone trained at
    its options, and the yesno HCLG as the denominator graph. -> {"lang",
    "model", "den_graph", "train", "test"}."""
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
    rng = np.random.RandomState(7)
    lang = gmm_stack(YESNO_LEXICON, YESNO_ARPA)[0]

    def corpus(prefix: str, n: int) -> list:
        out = []
        for i in range(n):
            ws = _yesno_words(rng)
            out.append((f"{prefix}_{i}",
                        mfcc_deltas(yesno_synth(ws, rng), device), ws))
        return out

    train, test = corpus("train", 16), corpus("test", 6)
    model = train_mono(lang, train, MonoTrainOpts(**MMI_MONO), device=device)
    g = arpa_to_g(ArpaLm.parse(YESNO_ARPA), lang.words)
    den = make_hclg(lang, g, model.trans_model, model.ctx_dep,
                    self_loop_scale=0.1)
    return dict(lang=lang, model=model, den_graph=den, train=train,
                test=test)


F64_EPS = 2.0 ** -53                     # f64 unit roundoff


def lattice_spread(lat, dll, tm, kappa: float) -> float:
    """The spread (largest less smallest) over the lattice's complete paths
    of kappa * sum_t dll[t, pdf(arc at t)]: rescoring the lattice with
    loglikes that differ by dll [T, P] moves each path's log-weight by
    that sum, so no two paths' log-weights move apart by more."""
    from kaldi_tpu_torch.lat.posteriors import lattice_state_times
    times, _T = lattice_state_times(lat)
    hi = np.full(lat.num_states, -np.inf)
    lo = np.full(lat.num_states, np.inf)
    hi[lat.start] = lo[lat.start] = 0.0
    for s in lat.topological_order():
        if not np.isfinite(hi[s]):
            continue
        for a in lat.arcs[s]:
            d = (kappa * float(dll[times[s], tm.transition_id_to_pdf(
                a.ilabel)]) if a.ilabel else 0.0)
            hi[a.nextstate] = max(hi[a.nextstate], hi[s] + d)
            lo[a.nextstate] = min(lo[a.nextstate], lo[s] + d)
    fin = [s for s in lat.finals if np.isfinite(hi[s])]
    if not fin:
        return 0.0
    return float(max(hi[s] for s in fin) - min(lo[s] for s in fin))


def _accuracy_moments(lat, tids, tm, criterion: str, sil,
                      one_silence_class: bool = True) -> tuple:
    """(E[A], Var[A]) of the path accuracy A under the lattice's
    posteriors, with `lattice_forward_backward_mpe_variants`' per-arc
    accuracy: a forward pass of each state's first and second moments of
    the prefix accuracy."""
    from kaldi_tpu_torch.lat.posteriors import lattice_state_times
    times, _T = lattice_state_times(lat)
    ref_pdf = [tm.transition_id_to_pdf(int(t)) for t in tids]
    ref_phone = [tm.transition_id_to_phone(int(t)) for t in tids]

    def acc(a, t):
        ph = tm.transition_id_to_phone(a.ilabel)
        ref_sil = ref_phone[t] in sil
        if one_silence_class and (ph in sil or ref_sil):
            return 1.0 if (ph in sil and ref_sil) else 0.0
        if criterion == "mpfe":
            return 1.0 if ph == ref_phone[t] else 0.0
        return 1.0 if tm.transition_id_to_pdf(a.ilabel) == ref_pdf[t] \
            else 0.0

    n = lat.num_states
    alpha = np.full(n, -np.inf)
    m1, m2 = np.zeros(n), np.zeros(n)
    alpha[lat.start] = 0.0
    for s in lat.topological_order():
        if alpha[s] == -np.inf:
            continue
        for a in lat.arcs[s]:
            j, lp = a.nextstate, alpha[s] - a.cost
            c = acc(a, int(times[s])) if a.ilabel else 0.0
            new = np.logaddexp(alpha[j], lp)
            w_old, w_new = np.exp(alpha[j] - new), np.exp(lp - new)
            m1[j] = w_old * m1[j] + w_new * (m1[s] + c)
            m2[j] = w_old * m2[j] + w_new * (m2[s] + 2 * c * m1[s] + c * c)
            alpha[j] = new
    fin = [(s, alpha[s] - g - ac) for s, (g, ac) in lat.finals.items()
           if alpha[s] > -np.inf]
    tot = np.logaddexp.reduce([lp for _s, lp in fin])
    e1 = sum(np.exp(lp - tot) * m1[s] for s, lp in fin)
    e2 = sum(np.exp(lp - tot) * m2[s] for s, lp in fin)
    return float(e1), float(max(e2 - e1 * e1, 0.0))


def disc_weight_bound(lat, ll_a, ll_b, tids, tm, opts, sil) -> tuple:
    """The bound on how far the signed pdf posteriors of one utterance
    (`lattice_forward_backward_mmi` or `_mpe_variants`, per
    opts.criterion) move when the lattice is rescored with loglikes ll_b
    [T, P] instead of ll_a, on the same lattice and numerator tids.

    With S the paths' `lattice_spread` and eta = e^S - 1, each path's
    posterior changes by a factor within [e^-S, e^S]. An entry's
    occupancy gamma (a set of paths) then moves by at most
    gamma (1 - gamma) eta: the MMI weight's bound. The MPE weight of
    (t, p) is Cov(1[path at (t, p)], A), A the path accuracy; under the
    reweighting it moves by at most eta (E[1 |A - E A|] + gamma (1 + eta)
    E|A - E A|) <= eta sqrt(Var A) (sqrt(gamma) + gamma (1 + eta)) (Cauchy-
    Schwarz; Var A from `_accuracy_moments`). Each side's f64
    forward-backward rounds its log-sums by at most 3 eps of their
    magnitude C per step, along at most L arcs and states: 24 (L + N)
    eps C of gamma (of gamma (T + 1) for MPE). The 1e-8 cuts (tid
    posteriors, cancelled weights) add 1e-8 per tid and one more. ->
    ({(t, pdf): bound} on a's rescored copy, frames whose MMI drop
    decision lies within its bound of the 1 - 1e-4 threshold, S)."""
    import copy
    from kaldi_tpu_torch.lat.functions import lattice_forward_backward
    from kaldi_tpu_torch.lat.posteriors import (lattice_to_post,
                                                rescore_lattice)
    kappa = opts.acoustic_scale
    la = rescore_lattice(copy.deepcopy(lat), ll_a, tm, kappa)
    S = lattice_spread(la, np.asarray(ll_b, np.float64)
                       - np.asarray(ll_a, np.float64), tm, kappa)
    eta = float(np.expm1(S))
    tid_post, _tot = lattice_to_post(la)
    _p, tot, alpha, beta = lattice_forward_backward(la)
    vals = np.concatenate([alpha[np.isfinite(alpha)], beta[np.isfinite(beta)],
                           [tot], [a.cost for arcs in la.arcs for a in arcs]])
    rho = 24.0 * (la.num_arcs + la.num_states) * F64_EPS * \
        float(np.max(np.abs(vals)))
    gamma: dict = {}
    ntid: dict = {}
    for t, frame in enumerate(tid_post):
        for tid, g in frame:
            key = (t, tm.transition_id_to_pdf(tid))
            gamma[key] = gamma.get(key, 0.0) + g
            ntid[key] = ntid.get(key, 0) + 1
    bound, straddle = {}, set()
    T = len(tid_post)
    if opts.criterion == "mmi":
        for key, g in gamma.items():
            bound[key] = (g * (1.0 - g) * eta + 1e-8 * (ntid[key] + 1)
                          + rho * (g + 1.0))
        for t in range(T):
            q = tm.transition_id_to_pdf(int(tids[t]))
            g = gamma.get((t, q), 0.0)
            b = bound.get((t, q), 1e-8 + rho)
            bound.setdefault((t, q), b)
            if abs((1.0 - g) - (1.0 - 1e-4)) <= b:
                straddle.add(t)
    else:
        _e, var = _accuracy_moments(la, tids, tm, opts.criterion, sil)
        sd = np.sqrt(var)
        for key, g in gamma.items():
            bound[key] = (eta * sd * (np.sqrt(g) + g * (1.0 + eta)) + 1e-8
                          + rho * g * (T + 1))
    return bound, straddle, S


def _signed_post(lat, ll, tids, tm, opts, sil) -> dict:
    """{(t, pdf): w} of one utterance: its lattice (a copy) rescored with
    ll and forward-backwarded for opts.criterion, as
    `discriminative_stats` does."""
    import copy
    from kaldi_tpu_torch.lat.posteriors import (
        lattice_forward_backward_mmi, lattice_forward_backward_mpe_variants,
        rescore_lattice)
    la = rescore_lattice(copy.deepcopy(lat), ll, tm, opts.acoustic_scale)
    if opts.criterion == "mmi":
        post = lattice_forward_backward_mmi(la, tids, tm, opts.drop_frames,
                                            opts.cancel)[0]
    else:
        post = lattice_forward_backward_mpe_variants(la, tids, tm,
                                                     opts.criterion, sil)[0]
    return {(t, p): w for t, fr in enumerate(post) for p, w in fr}


def weighted_stats_bound(u, du, gam, B, x, bound: list, scale: list):
    """Add to `bound` ([occ [G], mean_acc [G, D], var_acc [G, D]]) what N
    weighted terms u_n gamma_ng f(x_n) (f = 1, x, x^2) of a GMM statistic
    can move by when each weight moves by at most du_n and each
    posterior by at most B_ng: (du (gamma + B) + u B + (3 eps32 + 2 N
    eps64)(u + du)(gamma + B)) |f(x)|, the last term the f32 weight and
    product and the f64 sums of N terms; and to `scale` the terms'
    magnitude u gamma |f(x)|."""
    xa = np.abs(np.asarray(x, np.float64))
    rnd = 3 * F32_EPS + 2 * len(u) * F64_EPS
    W = (du[:, None] * (gam + B) + u[:, None] * B
         + rnd * (u + du)[:, None] * (gam + B))
    U = u[:, None] * gam
    for acc, M in ((bound, W), (scale, U)):
        acc[0] += M.sum(axis=0)
        acc[1] += M.T @ xa
        acc[2] += M.T @ (xa * xa)


def stats_errs(got, want, bound: list, scale: list) -> dict:
    """Two `AccumAmDiagGmm`s' largest difference over `bound` ("bound")
    and over the terms' magnitude `scale` ("terms"), per gaussian of all
    pdfs in order."""
    out = {"bound": 0.0, "terms": 0.0}
    for k, field in enumerate(("occ", "mean_acc", "var_acc")):
        g = np.concatenate([getattr(a, field) for a in got.accs])
        w = np.concatenate([getattr(a, field) for a in want.accs])
        out["bound"] = max(out["bound"], _worst(g, w, bound[k]))
        out["terms"] = max(out["terms"], _worst(g, w, np.maximum(
            scale[k], 1e-30)))
    return out


def disc_stats_card_vs_cpu(am_cpu, am_card, tm, lats, align, feats, nf,
                           opts, sil) -> tuple[dict, dict]:
    """One iteration's num and den statistics (`steps/mmi.
    discriminative_stats`) with the CPU's AM and with the card's, from
    copies of the same lattices and the same numerator alignment, each
    rescoring with its own loglikes; and the bound their difference must
    stay in.

    Each entry's signed weight w (t, pdf) moves by at most
    `disc_weight_bound` (plus the whole weight in a frame whose MMI drop
    decision straddles its threshold), and so does its positive (num) and
    negated negative (den) part; each gaussian's posterior within the pdf
    by at most `posterior_bound`'s B. A term u gamma f(x) of a statistic
    (f = 1, x, x^2) then moves by at most (dU (gamma + B) + u B + (3 eps32
    + 2 N eps64)(u + dU)(gamma + B)) |f(x)|: the f32 weight and product,
    and the f64 sums of N terms. -> ({"cpu": (num, den), "cuda": ...},
    errs: for the num and den statistics the largest difference over the
    bound ("bound", must be <= 1) and over the terms' magnitude ("terms");
    the weights' largest difference over their bound ("weight ratio", <=
    1), the largest path spread S, the straddling frames, and the
    objective of each)."""
    import copy
    from kaldi_tpu_torch.steps.mmi import discriminative_stats
    devs = (("cpu", am_cpu), ("cuda", am_card))
    ll = {d: am.loglikes_np(feats) for d, am in devs}
    stats, objf = {}, {}
    for d, am in devs:
        num, den, tot, frames, _used = discriminative_stats(
            am, tm, [copy.deepcopy(lat) for lat in lats], align, ll[d],
            feats, nf, opts, sil)
        stats[d], objf[d] = (num, den), tot / max(frames, 1)
    G, D = am_cpu.total_gauss, feats.shape[2]
    bound = {side: [np.zeros(G), np.zeros((G, D)), np.zeros((G, D))]
             for side in ("num", "den")}
    scale = {side: [np.zeros(G), np.zeros((G, D)), np.zeros((G, D))]
             for side in ("num", "den")}
    errs = {"weight ratio": 0.0, "S": 0.0, "straddle": 0,
            "objf": (objf["cpu"], objf["cuda"])}
    for b, lat in enumerate(lats):
        if lat is None or align[b] is None:
            continue
        tids = align[b][0]
        wb, straddle, S = disc_weight_bound(lat, ll["cpu"][b], ll["cuda"][b],
                                            tids, tm, opts, sil)
        errs["S"] = max(errs["S"], S)
        errs["straddle"] += len(straddle)
        post = {d: _signed_post(lat, ll[d][b], tids, tm, opts, sil)
                for d in ("cpu", "cuda")}
        keys = sorted(set(post["cpu"]) | set(post["cuda"]))
        w = {d: np.array([post[d].get(k, 0.0) for k in keys])
             for d in post}
        dw = np.array([wb.get(k, 2e-8) for k in keys]) + np.where(
            [k[0] in straddle for k in keys],
            np.maximum(np.abs(w["cpu"]), np.abs(w["cuda"])), 0.0)
        errs["weight ratio"] = max(errs["weight ratio"], _worst(
            w["cuda"], w["cpu"], dw))
        t_idx = np.array([k[0] for k in keys])
        pdfs = np.array([k[1] for k in keys])
        x = feats[b, t_idx]
        pb = posterior_bound(am_cpu, am_card, x, pdfs)
        for side, u in (("num", np.maximum(w["cpu"], 0.0)),
                        ("den", np.maximum(-w["cpu"], 0.0))):
            weighted_stats_bound(u, dw, pb["cpu"], pb["bound"], x,
                                 bound[side], scale[side])
    for i, side in enumerate(("num", "den")):
        errs[side] = stats_errs(stats["cuda"][i], stats["cpu"][i],
                                bound[side], scale[side])
    return stats, errs


def disc_small_setup() -> dict:
    """Phase 21's inputs: `mmi_system` on the CPU and a copy of its model
    on the card; the CPU's denominator lattices of the training set,
    boosted by 0.1 once with the CPU's numerator alignment, and that
    alignment (both devices get these); and the card's own alignment."""
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.lat.posteriors import lattice_boost
    from kaldi_tpu_torch.steps.mmi import MmiTrainOpts, make_denlats
    from kaldi_tpu_torch.steps.mono import compile_and_pad
    s = mmi_system("cpu")
    m_cpu = s["model"]
    m_card = gmm_model_on(m_cpu, "cuda")
    tm = m_cpu.trans_model
    sil = {s["lang"].phones["SIL"]}
    batch, feats, nf = compile_and_pad(s["lang"], tm, m_cpu.ctx_dep,
                                       s["train"], 1.0, 0.1)
    opts = MmiTrainOpts(boost=0.1, lattice_beam=8.0)
    _dec, lats = make_denlats(m_cpu, s["den_graph"], feats, nf, opts)
    align = viterbi_align(batch, m_cpu.am.loglikes(feats), nf, 0.1,
                          device="cpu")
    for lat, a in zip(lats, align):
        if lat is not None and a is not None:
            lattice_boost(lat, a[0], tm, opts.boost, sil)
    return dict(s, m_cpu=m_cpu, m_card=m_card, tm=tm, sil=sil, feats=feats,
                nf=nf, opts=opts, lats=lats, align=align,
                align_card=viterbi_align(batch, m_card.am.loglikes(feats),
                                         nf, 0.1, device="cuda"))


def smbr_step_card_vs_cpu(su: dict) -> dict:
    """One nnet sMBR step (`make_discriminative_step`, SGD at 3e-4) of a
    small TDNN (39 -> 64 relu over the yesno pdfs, seeded init with a
    random final layer) on the card and on the CPU
    (`disc_step_card_vs_cpu`)."""
    import torch
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    cfg = TdnnConfig(feat_dim=su["feats"].shape[2],
                     num_pdfs=su["m_cpu"].am.num_pdfs,
                     hidden_dim=64, pnorm_output_dim=16, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 1), (0,)))
    tdnn = Tdnn(cfg)
    tdnn.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        tdnn.final.w.copy_(torch.randn(tdnn.final.w.shape, generator=torch
                                       .Generator().manual_seed(1)) * 0.3)
    before = tdnn.params()
    return disc_step_card_vs_cpu(
        su, AmNnet(tdnn), lambda d: Tdnn.from_params(cfg, before, device=d))


def disc_step_card_vs_cpu(su: dict, am, model_on) -> dict:
    """One nnet sMBR step (`make_discriminative_step`, SGD at 3e-4) of
    `am`'s net (on the CPU) and of its copy on the card (`model_on(d)`:
    the net holding the same params on device d), from the same params,
    features (the first aligned utterance's, with context) and dense
    posteriors (from its lattice rescored with the CPU's loglikes). ->
    {"err": the params' largest difference over their terms' magnitude
    (per leaf, its largest |p| plus its largest step), "leaf": that per
    leaf, "moved": the largest step, "objf", "utt"}."""
    import copy
    import torch
    from kaldi_tpu_torch.nnet import discriminative as nd
    from kaldi_tpu_torch.nnet import optim
    feats, nf, lats, align = su["feats"], su["nf"], su["lats"], su["align"]
    before = am.model.params()
    b = next(i for i, (lat, a) in enumerate(zip(lats, align))
             if lat is not None and a is not None)
    lc, rc = (getattr(am.model, "left_context", None),
              getattr(am.model, "right_context", None))
    if lc is None:
        lc, rc = am.model.config.left_context, am.model.config.right_context
    f = np.pad(feats[b, : nf[b]], ((lc, rc), (0, 0)), mode="edge")
    ll = am.loglikes_np(f[None])[0][lc:lc + nf[b]]
    post, objf = nd.compute_discriminative_post(
        am, copy.deepcopy(lats[b]), align[b][0], su["tm"],
        nd.NnetDiscriminativeOpts(), ll, su["sil"])
    out = {}
    for d in ("cpu", "cuda"):
        model = model_on(d)
        tx = optim.sgd(3e-4)
        params = model.params()
        new, _st, _loss = nd.make_discriminative_step(model, tx)(
            params, tx.init(params), torch.as_tensor(f, device=d),
            torch.as_tensor(post, device=d))
        out[d] = {k: v.cpu() for k, v in new.items()}
    # a leaf's two terms, p and the step -lr g, at their largest in the
    # leaf: a bias that starts at 0 is all step, whose gradient sums
    # signed posteriors over the frames (it cancels elementwise)
    leaf = {k: float((out["cuda"][k] - out["cpu"][k]).abs().max())
            / max(float(before[k].abs().max())
                  + float((out["cpu"][k] - before[k]).abs().max()), 1e-30)
            for k in before}
    return {"err": max(leaf.values()), "leaf": leaf,
            "moved": max(float((out["cpu"][k] - before[k]).abs().max())
                         for k in before),
            "objf": objf, "utt": b}


def phase_disc_small():
    """tests/test_discriminative.py's yesno system, card vs CPU, on the
    same denominator lattices and numerator alignment
    (`disc_small_setup`): one MMI and one sMBR iteration's statistics
    (`disc_stats_card_vs_cpu`: each within the bound the two devices'
    loglikes set), the EBW-updated means and variances from each device's
    statistics (reported), and one nnet sMBR step
    (`smbr_step_card_vs_cpu`: params within 1e-5 of their terms).
    Neither kernel may launch."""
    from kaldi_tpu_torch.gmm.ebw import update_ebw_am_diag_gmm
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    check = _Limits()
    su = disc_small_setup()
    m_cpu, m_card, lats, align = su["m_cpu"], su["m_card"], su["lats"], \
        su["align"]
    same = sum(a is not None and g is not None and list(a[0]) == list(g[0])
               for a, g in zip(align, su["align_card"]))
    log(f"  yesno system: {len(su['train'])} training utterances, "
        f"{m_cpu.am.total_gauss} gaussians over {m_cpu.am.num_pdfs} pdfs; "
        f"{sum(lat is not None for lat in lats)} denominator lattices "
        f"(CPU, boosted 0.1), "
        f"{np.mean([lat.num_arcs for lat in lats if lat]):.1f} arcs mean; "
        f"the card's alignment equals the CPU's for {same} of "
        f"{len(su['nf'])}")
    for crit in ("mmi", "smbr"):
        opts = dataclasses.replace(su["opts"], criterion=crit)
        stats, errs = disc_stats_card_vs_cpu(
            m_cpu.am, m_card.am, su["tm"], lats, align, su["feats"],
            su["nf"], opts, su["sil"])
        check(f"{crit}: lattice weights over their bound",
              errs["weight ratio"], 1.0)
        for side in ("num", "den"):
            check(f"{crit}: {side} statistics over their bound",
                  errs[side]["bound"], 1.0)
        new = {d: update_ebw_am_diag_gmm(am, *stats[d], opts.ebw)
               for d, am in (("cpu", m_cpu.am), ("cuda", m_card.am))}
        dm = max(float(np.max(np.abs(g.means - c.means) / np.sqrt(c.vars)))
                 for g, c in zip(new["cuda"].pdfs, new["cpu"].pdfs))
        dv = max(float(np.max(np.abs(g.vars - c.vars) / c.vars))
                 for g, c in zip(new["cuda"].pdfs, new["cpu"].pdfs))
        log(f"  {crit}: objective/frame CPU {errs['objf'][0]:.6f}, card "
            f"{errs['objf'][1]:.6f}; lattice weights at "
            f"{errs['weight ratio']:.3f} of their bound (path spread S up "
            f"to {errs['S']:.3e} nats, {errs['straddle']} frames near the "
            f"drop threshold); num statistics {errs['num']['terms']:.3e} "
            f"of their terms ({errs['num']['bound']:.3f} of the bound), den "
            f"{errs['den']['terms']:.3e} ({errs['den']['bound']:.3f}); EBW "
            f"from each device's statistics: means {dm:.3e} of a std apart, "
            f"variances {dv:.3e} relative (reported, not limited)")
    st = smbr_step_card_vs_cpu(su)
    check("nnet sMBR step: params card vs CPU over their terms", st["err"])
    check.require("nnet sMBR step moved the params", st["moved"] > 0)
    log(f"  nnet sMBR step (TDNN 39 -> 64 relu, utterance {st['utt']}, "
        f"objective {st['objf']:.4f}): params card vs CPU {st['err']:.3e} "
        f"of their terms (limit 1e-5; per leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in st["leaf"].items())
        + f"), the step moved them by up to {st['moved']:.3e}")
    check.require(f"kernels launched on the discriminative path (gather "
                  f"{tg.launches}, qaffine {q.launches})",
                  tg.launches == 0 and q.launches == 0)
    check.done("phase 21")
    log(f"  launches: gather {tg.launches}, qaffine {q.launches}; phase 21 "
        f"took {time.perf_counter() - t0:.3f} s")


# tests/test_rm_like_recipe.py's pyramid (phase 22 a) and test_fmmi.py's
# fMMI options
RM_MONO = dict(num_iters=14, totgauss=140, max_iter_inc=10,
               realign_iters=tuple(range(1, 14)))
RM_TRI = dict(num_iters=12, totgauss=350, max_iter_inc=8, num_leaves=120,
              realign_iters=(1, 2, 3, 4, 5, 6, 8, 10))
RM_MMI = dict(num_iters=2, boost=0.1, lattice_beam=7.0, max_active=1024)
RM_FMMI = dict(num_iters=4, lattice_beam=8.0, fmpe_gauss=8)
RM_BARS = dict(mono=12.0, tri=10.0, mmi=8.0)
# phase 22 (b): train_mmi.sh's bMMI and train_discriminative2.sh's sMBR,
# cut for the time limit: bMMI of the ladder's tri in LADDER_BMMI_ITERS
# iterations (train_mmi.sh's 4 took 16.6 s on an NVIDIA H100 80GB HBM3 at
# 700 W), sMBR of the ladder's TDNN on the first SMBR_UTTS training
# utterances (3 epochs over all 200 took 59.0 s there, 18.3 s of each
# epoch in the host's posteriors)
LADDER_SMBR = dict(criterion="smbr", num_epochs=2, learning_rate=3e-4)
SMBR_UTTS = 50
LADDER_BMMI_ITERS = 2


def _disc_log(what: str, secs: float, stats: list, n_utts: int, card: str):
    lat_s = sum(st.get("rescore+fb", 0.0) for st in stats)
    used = sum(st.get("lattices", 0) for st in stats)
    den = stats[0].get("denlats")
    log(f"  {what}: {secs:.3f} s; per iteration: {_iter_ms(stats)}"
        + (f"; denlats {n_utts / den:.1f} lattices/s" if den else "")
        + (f"; rescore+fb {used / lat_s:.1f} lattices/s" if lat_s and used
           else "")
        + (f"; mean {stats[0]['mean_arcs']:.1f} arcs per lattice"
           if "mean_arcs" in stats[0] else "")
        + f"; None lattices {stats[0].get('den_none', 0)}, alignments "
        f"{max(st.get('align_none', 0) for st in stats)} | card: {card}")


def phase_disc_full(card: str, ladder: dict, profile: bool = False) -> dict:
    """(a) tests/test_rm_like_recipe.py's pyramid on the card (mono -> tri
    -> bMMI) with PARITY.md:32's bars, then fMMI at test_fmmi.py's options
    on that tri and at test_fmmi.py's own setup on the yesno system: each
    finite, its projection moved, its objective within 0.05 of its start,
    its WER against its base reported (PARITY.md:34 is not held: the
    reference's fMMI breaks it on both systems, tests/test_torch_fmmi.py);
    (b) on phase 20's ladder models at the ladder's width: bMMI from tri
    (2 iterations, its unigram HCLG by make_hclg) and sMBR of the TDNN (2
    epochs over the first 50 training utterances, on denominator lattices
    from its own loglikes through make_hclg_flat + CsrBeamDecoder,
    numerator tids from the LDA+MLLT model it was aligned with), each
    objective non-decreasing and finite; WERs before and after
    reported."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchOpts
    from kaldi_tpu_torch.decoder.dense import make_decoder
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.nnet import discriminative as nd
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.steps import deltas, fmmi, mmi, mono
    from kaldi_tpu_torch.transform.fmpe import FmpeOptions

    t0 = time.perf_counter()
    q.launches = tg.launches = 0
    # (a) the rm-like pyramid
    rng = np.random.RandomState(17)
    train_w, test_w = rm_corpus(rng, 42), rm_corpus(rng, 12)
    train = [(f"tr{i}", mfcc_deltas(w, "cuda"), ws)
             for i, (ws, w) in enumerate(train_w)]
    test = [(f"te{i}", mfcc_deltas(w, "cuda"), ws)
            for i, (ws, w) in enumerate(test_w)]
    lang = prepare_lang(Lexicon.parse(RM_LEXICON), ["SIL"], "SIL",
                        num_sil_states=3)
    g = arpa_to_g(ArpaLm.parse(rm_unigram_arpa()), lang.words)
    sil = {lang.phones["SIL"]}
    refs = [ws for _u, _f, ws in test]

    def rm_wer(model, graph=None, transform=None):
        if graph is None:
            graph = make_hclg(lang, g, model.trans_model, model.ctx_dep,
                              self_loop_scale=0.1)
        dec = make_decoder(pack_graph(graph.fst,
                                      model.trans_model.id2pdf_array),
                           BeamSearchOpts(beam=14.0, max_active=1024,
                                          acoustic_scale=0.1),
                           device="cuda")
        fb, nf = pad_batch([transform(f).astype(np.float32) if transform
                            else f for _u, f, _w in test])
        res = dec.decode(model.am.loglikes(fb), nf)
        return wer(refs, [[lang.words.sym(x) for x in r[0]] if r else []
                          for r in res]), graph

    secs = {}
    t = time.perf_counter()
    mono_m = mono.train_mono(lang, train, mono.MonoTrainOpts(**RM_MONO),
                             device="cuda")
    secs["mono"] = time.perf_counter() - t
    w_mono, _g = rm_wer(mono_m)
    t = time.perf_counter()
    tri = deltas.train_deltas(lang, train, mono_m,
                              deltas.DeltasTrainOpts(**RM_TRI))
    secs["tri"] = time.perf_counter() - t
    w_tri, graph = rm_wer(tri)
    st_mmi: list = []
    t = time.perf_counter()
    am_mmi, hist = mmi.train_discriminative(
        tri, graph, train, mmi.MmiTrainOpts(**RM_MMI), silence_phones=sil,
        iter_stats=st_mmi)
    secs["bmmi"] = time.perf_counter() - t
    w_mmi, _g = rm_wer(mono.MonoModel(am_mmi, tri.trans_model, tri.ctx_dep,
                                      lang), graph)
    _disc_log(f"(a) bMMI {RM_MMI} from tri on {len(train)} utterances "
              f"(objective/frame {', '.join(f'{h:.5f}' for h in hist)})",
              secs["bmmi"], st_mmi, len(train), card)
    st_f: list = []
    t = time.perf_counter()
    fm, am_f, hist_f = fmmi.train_fmmi(
        tri, graph, train, fmmi.FmmiTrainOpts(
            fmpe=FmpeOptions(learning_rate=0.002), **RM_FMMI),
        silence_phones=sil, iter_stats=st_f)
    secs["fmmi"] = time.perf_counter() - t
    w_fmmi, _g = rm_wer(mono.MonoModel(am_f, tri.trans_model, tri.ctx_dep,
                                       lang), graph, fm.apply)
    _disc_log(f"(a) fMMI {RM_FMMI} from tri (objective/frame "
              f"{', '.join(f'{h:.5f}' for h in hist_f)})", secs["fmmi"],
              st_f, len(train), card)
    # fMMI at tests/test_fmmi.py's own setup: the yesno system
    t = time.perf_counter()
    ys = mmi_system("cuda")
    st_y: list = []
    fm_y, am_y, hist_y = fmmi.train_fmmi(
        ys["model"], ys["den_graph"], ys["train"][:10], fmmi.FmmiTrainOpts(
            fmpe=FmpeOptions(learning_rate=0.002), **RM_FMMI),
        silence_phones={ys["lang"].phones["SIL"]}, iter_stats=st_y)
    secs["fmmi_yesno"] = time.perf_counter() - t
    dec_y = make_decoder(pack_graph(ys["den_graph"].fst,
                                    ys["model"].trans_model.id2pdf_array),
                         BeamSearchOpts(beam=16.0, max_active=256,
                                        acoustic_scale=0.1), device="cuda")

    def yesno_wer(am, transform):
        fb, nf = pad_batch([transform(f).astype(np.float32)
                            for _u, f, _w in ys["test"]])
        res = dec_y.decode(am.loglikes(fb), nf)
        return wer([w for _u, _f, w in ys["test"]],
                   [[ys["lang"].words.sym(x) for x in r[0]] if r else []
                    for r in res])

    w_ybase = yesno_wer(ys["model"].am, lambda f: f)
    w_yfmmi = yesno_wer(am_y, fm_y.apply)
    _disc_log(f"(a) fMMI at tests/test_fmmi.py's setup (yesno mono, 10 "
              f"utterances; objective/frame "
              f"{', '.join(f'{h:.5f}' for h in hist_y)})",
              secs["fmmi_yesno"], st_y, 10, card)
    checks = [("mono <= 12", w_mono <= RM_BARS["mono"]),
              ("tri <= 10", w_tri <= RM_BARS["tri"]),
              ("tri <= mono", w_tri <= w_mono),
              ("bMMI <= tri", w_mmi <= w_tri),
              ("bMMI <= 8", w_mmi <= RM_BARS["mmi"]),
              ("bMMI objective does not fall", hist[-1] >= hist[0] - 1e-3),
              ("fMMI objective within 0.05 of its start",
               hist_y[-1] >= hist_y[0] - 0.05
               and hist_f[-1] >= hist_f[0] - 0.05),
              ("fMMI projections moved", float(np.abs(fm_y.M).max()) > 0
               and float(np.abs(fm.M).max()) > 0),
              ("finite", bool(np.isfinite(hist).all()
                              and np.isfinite(hist_f).all()
                              and np.isfinite(hist_y).all()))]
    log(f"  (a) PYRAMID: mono {w_mono:.2f} -> tri {w_tri:.2f} -> tri+bMMI "
        f"{w_mmi:.2f}; fMMI from tri {w_fmmi:.2f}, on yesno {w_yfmmi:.2f} "
        f"against its base {w_ybase:.2f} (PARITY.md:34 reported, not held: "
        f"JAX's fMMI breaks it on these systems too, "
        f"tests/test_torch_fmmi.py); seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + "; "
        + ", ".join(f"{c} {'ok' if ok else 'FAILS'}" for c, ok in checks)
        + f" | card: {card}")
    failed = [c for c, ok in checks if not ok]
    if failed:
        raise AssertionError(f"rm-like pyramid: {failed} fail")
    if tg.launches or q.launches:
        raise AssertionError(f"kernels launched on the GMM discriminative "
                             f"path: gather {tg.launches}, qaffine "
                             f"{q.launches}")

    # (b) the ladder's models at the ladder's width
    L = ladder["models"]
    lang_l, arpa, dopts, refs_l = L["lang"], L["arpa"], L["dopts"], L["refs"]
    sil_l = {lang_l.phones["SIL"]}
    shapes = set()

    def ladder_wer(model, test_utts):
        dec, _gs = ladder_decoder(model, arpa, dopts, "cuda")
        fb, nf = pad_batch([f for _u, f, _w in test_utts])
        ll = model.am.loglikes(fb)
        shapes.update(csr_gather_shapes(dec, ll.shape[0], ll.shape[2]))
        return wer(refs_l, [[lang_l.words.sym(x) for x in r[0]] if r else []
                            for r in dec.decode(ll, nf)])

    tri_l, den = L["tri"], L["tri_hclg"]
    st_b: list = []
    t = time.perf_counter()
    bopts = mmi.MmiTrainOpts(num_iters=LADDER_BMMI_ITERS, boost=0.1)
    am_b, hist_b = mmi.train_discriminative(
        tri_l, den, L["train"], bopts, silence_phones=sil_l,
        iter_stats=st_b)
    bmmi_s = time.perf_counter() - t
    w_b = ladder_wer(mono.MonoModel(am_b, tri_l.trans_model, tri_l.ctx_dep,
                                    lang_l), L["test"])
    n_frames = sum(f.shape[0] for _u, f, _w in L["train"])
    _disc_log(f"(b) bMMI {bopts} from the ladder's "
              f"tri ({tri_l.am.num_pdfs} leaves, {tri_l.am.total_gauss} "
              f"gaussians) on {len(L['train'])} utterances ({n_frames} "
              f"frames); den HCLG (phase 20's make_hclg) "
              f"{den.fst.num_states} states in {ladder['obj_graph_s']:.3f} "
              f"s; objective/frame "
              f"{', '.join(f'{h:.5f}' for h in hist_b)}", bmmi_s, st_b,
              len(L["train"]), card)
    w_tri_l = ladder["tri"]["wer"]
    log(f"  (b) bMMI test WER {w_b:.2f} against tri's {w_tri_l:.2f}: bMMI "
        f"{'beats' if w_b < w_tri_l else 'ties' if w_b == w_tri_l else 'does not beat'}"
        f" tri | card: {card}")

    # sMBR of the TDNN: numerator tids from the LDA+MLLT model it was
    # aligned with, denominator lattices from its own loglikes
    lda_m, nnet = L["lda"].model, L["nnet"]
    am_n = nnet.am
    t = time.perf_counter()
    batch, feats_l, nf_l = mono.compile_and_pad(
        lang_l, lda_m.trans_model, lda_m.ctx_dep, L["train_l"][:SMBR_UTTS],
        1.0, 0.1)
    ali = viterbi_align(batch, lda_m.am.loglikes(feats_l), nf_l, 0.1,
                        device="cuda")
    nn_model = mono.MonoModel(am_n, lda_m.trans_model, lda_m.ctx_dep, lang_l)
    dec, _gs = ladder_decoder(nn_model, arpa, dopts, "cuda")
    ll_n = am_n.loglikes(feats_l)
    shapes.update(csr_gather_shapes(dec, ll_n.shape[0], ll_n.shape[2]))
    lats_n = decode_to_lattices(dec, ll_n.cpu().numpy(), nf_l,
                                lattice_beam=8.0)
    den_n_s = time.perf_counter() - t
    cfg = am_n.model.config
    lc, rc = cfg.left_context, cfg.right_context
    egs = [(np.pad(feats_l[b, : nf_l[b]], ((lc, rc), (0, 0)), mode="edge"),
            ali[b][0], lat) for b, lat in enumerate(lats_n)
           if lat is not None and ali[b] is not None]
    save_witness(SMBR_WITNESS, smbr_witness_data(
        am_n, lda_m.trans_model, egs[0],
        nd.NnetDiscriminativeOpts(**LADDER_SMBR), sil_l))
    st_n: list = []
    t = time.perf_counter()
    params, hist_n = nd.train_nnet_discriminative(
        am_n, lda_m.trans_model, egs, nd.NnetDiscriminativeOpts(
            **LADDER_SMBR), silence_phones=sil_l, iter_stats=st_n)
    smbr_s = time.perf_counter() - t
    w_n = ladder_wer(mono.MonoModel(am_n.replace_params(params),
                                    lda_m.trans_model, lda_m.ctx_dep,
                                    lang_l), L["test_l"])
    n_none = sum(lat is None for lat in lats_n)
    log(f"  (b) sMBR {LADDER_SMBR} of the ladder's TDNN on {len(egs)} egs: "
        f"alignment and denominator lattices (CsrBeamDecoder, lattice beam "
        f"8) in {den_n_s:.3f} s ({len(lats_n) / den_n_s:.1f} lattices/s, "
        f"{np.mean([lat.num_arcs for _f, _a, lat in egs]):.1f} arcs mean; "
        f"None lattices {n_none}, alignments "
        f"{sum(a is None for a in ali)}); trained in {smbr_s:.3f} s; per "
        f"epoch: {_iter_ms(st_n)}; expected accuracy/frame "
        f"{', '.join(f'{h:.5f}' for h in hist_n)}; test WER {w_n:.2f} "
        f"against the TDNN's {ladder['tdnn']['wer']:.2f} | card: {card}")
    checks = [("bMMI objective does not fall", hist_b[-1] >= hist_b[0] - 1e-3),
              ("sMBR objective does not fall", hist_n[-1] >= hist_n[0] - 1e-3),
              ("finite", bool(np.isfinite(hist_b).all()
                              and np.isfinite(hist_n).all()
                              and all(bool(torch.isfinite(v).all())
                                      for v in params.values())
                              and all(np.isfinite(p.means).all()
                                      and np.isfinite(p.vars).all()
                                      for p in am_b.pdfs)))]
    log("  (b) " + ", ".join(f"{c} {'ok' if ok else 'FAILS'}"
                             for c, ok in checks))
    failed = [c for c, ok in checks if not ok]
    if failed:
        raise AssertionError(f"ladder discriminative: {failed} fail")
    if q.launches:
        raise AssertionError(f"qaffine launched {q.launches} times")
    launches = tg.launches
    log(f"  launches: gather {launches} (the ladder's decodes), qaffine "
        f"{q.launches}; phase 22 took {time.perf_counter() - t0:.3f} s")
    g_times = gather_at_shapes(tg, sorted(shapes), "the discriminative "
                               "path's", 5)
    if profile:
        profile_disc(tri_l, den, L["train"], egs, am_n, lda_m.trans_model,
                     sil_l)
    return dict(launches=launches, gather_times=g_times,
                wer=dict(mono=w_mono, tri=w_tri, bmmi=w_mmi, fmmi=w_fmmi,
                         fmmi_yesno=w_yfmmi, yesno_base=w_ybase,
                         ladder_bmmi=w_b, ladder_smbr=w_n))


def profile_disc(tri, den, utts, egs, am_n, tm, sil):
    """One bMMI iteration's work with the ladder's tri (loglikes,
    alignment, rescore+fb, accumulation, EBW) on fresh denominator
    lattices, and one sMBR epoch over 20 egs, under torch.profiler."""
    import copy
    import torch
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.gmm.ebw import update_ebw_am_diag_gmm
    from kaldi_tpu_torch.nnet import discriminative as nd
    from kaldi_tpu_torch.steps import mmi
    from kaldi_tpu_torch.steps.mono import compile_and_pad
    batch, feats, nf = compile_and_pad(tri.lang, tri.trans_model,
                                       tri.ctx_dep, utts, 1.0, 0.1)
    opts = mmi.MmiTrainOpts(boost=0.1)
    _d, lats = mmi.make_denlats(tri, den, feats, nf, opts)
    fresh = [[copy.deepcopy(lat) for lat in lats] for _ in range(2)]
    sub = [[(f, a, copy.deepcopy(lat)) for f, a, lat in egs[:20]]
           for _ in range(2)]

    def bmmi_iteration():
        ll = tri.am.loglikes(feats)
        align = viterbi_align(batch, ll, nf, opts.acoustic_scale,
                              device=tri.am.device)
        num, den_acc, *_ = mmi.discriminative_stats(
            tri.am, tri.trans_model, fresh.pop(), align, ll.cpu().numpy(),
            feats, nf, opts, sil)
        update_ebw_am_diag_gmm(tri.am, num, den_acc, opts.ebw)

    def smbr_epoch():
        nd.train_nnet_discriminative(am_n, tm, sub.pop(),
                                     nd.NnetDiscriminativeOpts(
                                         **LADDER_SMBR | dict(num_epochs=1)),
                                     silence_phones=sil)

    for what, fn in (("bMMI iteration", bmmi_iteration),
                     ("sMBR epoch over 20 egs", smbr_epoch)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        busy, n_ops, by_name = device_time(fn)
        log_profile(what, "call", 1, busy, n_ops, by_name, host_s, 8)


# phase 23: the neural families at the CPU tests' widths, card vs CPU
NNET_SMALL = {
    "tdnn": dict(feat_dim=8, num_targets=12, hidden_dim=16,
                 splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)),
                 nonlinearity="PnormComponent", pnorm_output_dim=4),
    "lstm": dict(feat_dim=8, num_targets=12, cell_dim=16, proj_dim=8,
                 num_layers=2, splice=(-1, 0, 1))}
# card vs CPU limits of phase 23's forwards, relative to the output's
# largest |y|: f32 with TF32 off, so cuBLAS and the CPU sum the same
# products in another order (PARITY.md's 1e-5 bar for one package against
# the other on the CPU)
NNET_FORWARD_LIMIT = 1e-5


def nnet3_small_config(which: str) -> str:
    from kaldi_tpu_torch.nnet3.configs import make_lstm_config, make_tdnn_config
    kw = NNET_SMALL[which]
    return (make_tdnn_config(**kw) if which == "tdnn"
            else make_lstm_config(**kw))


def _nnet3_nets(cfg: str, seed: int) -> dict:
    """The config's Nnet3 on the card and on the CPU, holding the same
    seeded init."""
    import torch
    from kaldi_tpu_torch.nnet3.network import Nnet3
    nets = {d: Nnet3(cfg, device=d) for d in ("cuda", "cpu")}
    p = nets["cpu"].init(torch.Generator().manual_seed(seed))
    nets["cuda"].load_state_dict(p)
    return nets


def nnet3_forward_card_vs_cpu(which: str, seed: int = 0) -> float:
    """The largest |card - CPU| over the CPU output's largest |y|, in decode
    (pad_context) and chunk mode, of a small net from `nnet3_small_config`
    (dense executor for the TDNN, recurrent for the LSTM)."""
    import torch
    nets = _nnet3_nets(nnet3_small_config(which), seed)
    x = np.random.RandomState(seed).randn(3, 30, 8).astype(np.float32)
    err = 0.0
    for pad in (True, False):
        y = {d: n(torch.as_tensor(x, device=d), pad_context=pad).cpu()
             for d, n in nets.items()}
        err = max(err, float((y["cuda"] - y["cpu"]).abs().max())
                  / float(y["cpu"].abs().max()))
    return err


def _nnet3_batches(net, n: int, seed: int, B: int = 4, T: int = 8) -> list:
    rng = np.random.RandomState(seed)
    lc, rc = net.left_context, net.right_context
    P = net.dims["output"]
    return [(rng.randn(B, T + lc + rc, net.dims["input"]).astype(np.float32),
             rng.randint(0, P, (B, T)).astype(np.int32),
             rng.uniform(0.5, 1.5, (B, T)).astype(np.float32))
            for _ in range(n)]


def _nnet3_steps_on(net, batches: list, opts) -> tuple[dict, list, list]:
    """len(batches) `make_nnet3_train_step` steps from the net's weights,
    where the net is. -> (params on the CPU, losses, seconds per step)."""
    import torch
    from kaldi_tpu_torch.nnet3.training import (make_nnet3_optimizer,
                                                make_nnet3_train_step)
    dev = net.device
    opt = make_nnet3_optimizer(net, opts, len(batches))
    step = make_nnet3_train_step(net, opt)
    params = net.params()
    state = opt.init(params)
    losses, secs = [], []
    for b in batches:
        t = time.perf_counter()
        params, state, loss, _acc = step(
            params, state, *(torch.as_tensor(a, device=dev) for a in b))
        losses.append(float(loss))          # syncs the device
        secs.append(time.perf_counter() - t)
    return {k: v.cpu() for k, v in params.items()}, losses, secs


NNET3_SMALL_OPTS = dict(initial_lr=0.05, final_lr=0.01, momentum=0.5,
                        max_grad_norm=1.0, ng_update_period=4)


def nnet3_steps_card_vs_cpu(which: str, seed: int = 1, steps: int = 8):
    """`steps` NG-SGD steps (refresh every 4, clip 1.0, momentum 0.5) of a
    small net on the card and the CPU from the same init and batches ->
    (leaf, loss) errors held to TRAIN_LIMITS["ng_sgd"]."""
    from kaldi_tpu_torch.nnet3.training import Nnet3TrainOpts
    nets = _nnet3_nets(nnet3_small_config(which), seed)
    batches = _nnet3_batches(nets["cpu"], steps, seed)
    opts = Nnet3TrainOpts(**NNET3_SMALL_OPTS)
    runs = [_nnet3_steps_on(nets[d], batches, opts)[:2]
            for d in ("cuda", "cpu")]
    return _train_errors("ng_sgd", *runs)


FRMSHUFF_PROTO = ("<AffineTransform> <InputDim> 8 <OutputDim> 32\n"
                  "<Sigmoid> <InputDim> 32 <OutputDim> 32\n"
                  "<AffineTransform> <InputDim> 32 <OutputDim> 12\n"
                  "<Softmax> <InputDim> 12 <OutputDim> 12\n")


def frmshuff_card_vs_cpu(seed: int = 2):
    """One `train_frmshuff` pass (momentum 0.5) of a small sigmoid net on
    the card and the CPU over the same frames -> (leaf, loss) errors held
    to TRAIN_LIMITS["f32"]."""
    import torch
    from kaldi_tpu_torch.nnet1.nnet import Nnet1, train_frmshuff
    rng = np.random.RandomState(seed)
    feats = rng.randn(300, 8).astype(np.float32)
    targets = rng.randint(0, 12, 300)
    p0 = Nnet1.from_proto(FRMSHUFF_PROTO, device="cpu").init(
        torch.Generator().manual_seed(seed), param_stddev=0.3)
    runs = []
    for d in ("cuda", "cpu"):
        net = Nnet1.from_proto(FRMSHUFF_PROTO, device=d)
        p, hist = train_frmshuff(net, {k: v.to(d) for k, v in p0.items()},
                                 feats, targets, learn_rate=0.1,
                                 minibatch=64, momentum=0.5, seed=seed)
        runs.append(({k: v.cpu() for k, v in p.items()}, [hist[0][0]]))
    return _train_errors("f32", *runs)


def lstm_streams_card_vs_cpu(seed: int = 3):
    """`train_lstm_streams` over 2 chunks (2 streams x 6 frames, one stream
    reset between them) of a 2-layer projected LSTM on the card and the
    CPU -> (leaf, loss) errors held to TRAIN_LIMITS["f32"]."""
    import torch
    from kaldi_tpu_torch.nnet1.lstm import LstmConfig, LstmProjected
    from kaldi_tpu_torch.nnet1.train import StreamTrainOpts, train_lstm_streams
    rng = np.random.RandomState(seed)
    utts = [(rng.randn(n, 8).astype(np.float32), rng.randint(0, 12, n))
            for n in (12, 5, 6)]
    cfg = LstmConfig(input_dim=8, cell_dim=16, proj_dim=8)
    p0 = LstmProjected(cfg, 12, num_layers=2, device="cpu").init(
        torch.Generator().manual_seed(seed))
    runs = []
    for d in ("cuda", "cpu"):
        model = LstmProjected(cfg, 12, num_layers=2, device=d)
        p, hist = train_lstm_streams(
            model, {k: v.to(d) for k, v in p0.items()}, utts,
            StreamTrainOpts(num_streams=2, bptt_chunk=6, learning_rate=0.1))
        runs.append(({k: v.cpu() for k, v in p.items()}, hist))
    return _train_errors("f32", *runs)


def cd1_card_vs_cpu(seed: int = 4) -> float:
    """A CD-1 update of a gaussian-bernoulli RBM (40 x 64, minibatch 32) on
    the card and the CPU from the same init, data and hidden sample (drawn
    once on the CPU from the CPU's P(h|v)) -> the largest error of W, the
    biases and the velocities over each one's largest |value|."""
    import torch
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    cfg = RbmConfig(visible_dim=40, hidden_dim=64, learning_rate=0.05)
    v = torch.as_tensor(np.random.RandomState(seed).randn(32, 40)
                        .astype(np.float32))
    rbms = {d: Rbm(cfg, seed=seed, device=d) for d in ("cuda", "cpu")}
    sample = rbms["cpu"].sample_hidden(rbms["cpu"].propagate(v),
                                       torch.Generator().manual_seed(seed))
    for d, r in rbms.items():
        r.cd1_update(v.to(d), sample.to(d))
    a, b = rbms["cuda"], rbms["cpu"]
    pairs = [(a.W, b.W), (a.vis_bias, b.vis_bias),
             (a.hid_bias, b.hid_bias)] + list(zip(a._vel, b._vel))
    return max(float((x.cpu() - y).abs().max()) / float(y.abs().max())
               for x, y in pairs)


def nnet3_smbr_step_card_vs_cpu(su: dict) -> dict:
    """`smbr_step_card_vs_cpu` for a config-built nnet3 TDNN (39 -> 64 relu
    over the yesno pdfs, seeded init with a random final layer) behind
    `AmNnet3`."""
    import torch
    from kaldi_tpu_torch.nnet3.configs import make_tdnn_config
    from kaldi_tpu_torch.nnet3.network import Nnet3, param_name
    from kaldi_tpu_torch.nnet3.training import AmNnet3
    cfg = make_tdnn_config(su["feats"].shape[2], su["m_cpu"].am.num_pdfs,
                           splice_indexes=((-2, -1, 0, 1, 2), (-1, 1), (0,)),
                           hidden_dim=64)
    net = Nnet3(cfg, device="cpu")
    net.init(torch.Generator().manual_seed(0))
    w = getattr(net.comp, "final%2Eaffine").w
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(1)) * 0.3)
    before = net.params()
    assert param_name("final.affine", "w") in before

    def model_on(d):
        m = Nnet3(cfg, device=d)
        m.load_state_dict(before)
        return m

    return disc_step_card_vs_cpu(su, AmNnet3(net), model_on)


def phase_nnet_small():
    """The nnet3 and nnet1 families at the CPU tests' widths, card vs CPU:
    the dense (TDNN) and recurrent (LSTM) executors' forwards, 8 nnet3
    NG-SGD steps of each, one `train_frmshuff` pass, 2
    `train_lstm_streams` chunks, a CD-1 update from a shared hidden sample
    and one nnet3 sMBR step on phase 21's shared lattices. Neither kernel
    may launch."""
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    check = _Limits()
    for which in ("tdnn", "lstm"):
        err = check(f"{which} forward, card vs CPU",
                    nnet3_forward_card_vs_cpu(which), NNET_FORWARD_LIMIT)
        leaf, loss = nnet3_steps_card_vs_cpu(which)
        log(f"  nnet3 {which} ({NNET_SMALL[which]}): forward card vs CPU "
            f"{err:.3e} of max |y| (limit {NNET_FORWARD_LIMIT}); 8 NG-SGD "
            f"steps ({NNET3_SMALL_OPTS}): leaves within {leaf:.3e} of their "
            f"max |p|, losses {loss:.3e} (limits {TRAIN_LIMITS['ng_sgd']})")
    leaf, loss = frmshuff_card_vs_cpu()
    log(f"  nnet1 train_frmshuff (8 -> 32 sigmoid -> 12, 300 frames, "
        f"minibatch 64, momentum 0.5): leaves within {leaf:.3e}, loss "
        f"{loss:.3e} (limits {TRAIN_LIMITS['f32']})")
    leaf, loss = lstm_streams_card_vs_cpu()
    log(f"  nnet1 train_lstm_streams (2 layers, cell 16, proj 8; 2 chunks "
        f"of 2 streams x 6 frames): leaves within {leaf:.3e}, loss "
        f"{loss:.3e} (limits {TRAIN_LIMITS['f32']})")
    err = check("RBM CD-1 update, card vs CPU", cd1_card_vs_cpu())
    log(f"  RBM CD-1 (gaussian 40 x bernoulli 64, shared sample): W, biases "
        f"and velocities within {err:.3e} of their max (limit 1e-5)")
    su = disc_small_setup()
    st = nnet3_smbr_step_card_vs_cpu(su)
    check("nnet3 sMBR step: params card vs CPU over their terms", st["err"])
    check.require("nnet3 sMBR step moved the params", st["moved"] > 0)
    log(f"  nnet3 sMBR step (config TDNN 39 -> 64 relu, utterance "
        f"{st['utt']}, objective {st['objf']:.4f}): params card vs CPU "
        f"{st['err']:.3e} of their terms (limit 1e-5), the step moved them "
        f"by up to {st['moved']:.3e}")
    check.require(f"kernels launched on the nnet families' small path "
                  f"(gather {tg.launches}, qaffine {q.launches})",
                  tg.launches == 0 and q.launches == 0)
    check.done("phase 23")
    log(f"  launches: gather {tg.launches}, qaffine {q.launches}; phase 23 "
        f"took {time.perf_counter() - t0:.3f} s")


# phase 24: the nnet families at the ladder's width, on phase 20's models.
# (a) the nnet2 rung's width and options, through the nnet3 trainer (NG on)
LADDER_TDNN3 = dict(splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)),
                    hidden_dim=512, pnorm_output_dim=128)
# phase 20's rates, epochs and minibatch with tests/test_yesno_e2e.py's
# nnet3 momentum (0.9): without it the p-norm stack under NG-SGD barely
# moves in 14 epochs (a CPU dry run at a cut size: loss 5.66 -> 5.32,
# where phase 20's relu TDNN went 5.08 -> 3.33)
LADDER_NNET3 = dict(LADDER_NNET, momentum=0.9)
# (b) train_lstm3's own architecture; the optimizer of
# tests/test_nnet3_recurrent.py's LSTM hybrid, 2 epochs of the ladder (10
# took 21.0 s on an NVIDIA H100 80GB HBM3 at 700 W, 3 11.6 s; cut for the
# time limit)
LADDER_LSTM3_OPTS = dict(initial_lr=0.15, final_lr=0.02, num_epochs=2,
                         minibatch_size=64, momentum=0.9)
# Kaldi's nnet3 LSTM recipe width (egs/wsj/s5/local/nnet3/run_lstm.sh:
# cell 1024, recurrent projection 256, 3 layers, chunk width 20, 100
# chunks per minibatch), random weights from a seed
WIDE_LSTM = dict(cell_dim=1024, proj_dim=256, num_layers=3)
WIDE_CHUNK, WIDE_MB, WIDE_STEPS, WIDE_UTTS = 20, 100, 4, 8
# the wide LSTM, card vs CPU: its forward relative to max |y| over 3
# recurrent layers of K = 1280-term sums and ~300 steps; its steps at
# TRAIN_LIMITS["ng_sgd"] (NG's eigh on cuSOLVER against LAPACK)
WIDE_FORWARD_LIMIT = 1e-4
# (c) steps/nnet/pretrain_dbn.sh: 6 x 2048 sigmoid RBMs over splice +-5 of
# the features with global CMVN, gaussian-bernoulli first, one CD-1 epoch
# each (rbm-train-cd1-frmshuff's minibatch 100) at RbmConfig's rates,
# except the gaussian-bernoulli layer's: at 0.01 the reference's CD-1
# diverges at 2048 hidden units (reconstruction MSE 15.5 -> 1.1e4 -> nan
# in 6 steps on the ladder's features, JAX's algorithm), so it gets 0.001.
# Then steps/nnet/train.sh's frame-shuffled fine-tuning: lr 0.008 on the
# minibatch's summed gradient, i.e. 0.008 x 256 on train_frmshuff's mean
DBN = dict(layers=6, hidden=2048, splice=tuple(range(-5, 6)), rbm_mb=100,
           gb_lr=0.001, ft_lr=0.008 * 256, ft_mb=256, ft_epochs=8)


def _dbn_inputs(utts, dev, stats=None):
    """Each utterance's features spliced +-5 (clamped at its edges, as
    splice-feats does) on `dev`, normalized by the training set's global
    mean and std (`stats`, computed here when None). -> (list of [T, 330],
    stats)."""
    import torch
    from kaldi_tpu_torch.nnet.components import splice
    xs = [splice(torch.as_tensor(f, device=dev), DBN["splice"])
          for f in utts]
    if stats is None:
        allx = torch.cat(xs)
        stats = (allx.mean(0), allx.std(0, unbiased=False))
    return [(x - stats[0]) / stats[1] for x in xs], stats


def cd1_witness_step(rbm, v, gen) -> dict:
    """`rbm.cd1_step(v, gen)` split at its hidden sample (as cd1_step
    splits it), recorded for the DBN witness: the RbmConfig, v, the
    sample (uint8 when bernoulli), W and the biases before, the MSE, and
    after it vis_bias and the first DBN_WITNESS_ROWS rows of W and
    hid_bias."""
    import dataclasses

    def host(t):
        return t.detach().cpu().numpy().copy()
    h_pos = rbm.propagate(v)
    h = rbm.sample_hidden(h_pos, gen)
    out = dict(cfg=dataclasses.asdict(rbm.cfg), v=host(v),
               h_sample=host(h).astype(np.uint8) if rbm.cfg.hidden_type
               == "bernoulli" else host(h),
               W=host(rbm.W), vis_bias=host(rbm.vis_bias),
               hid_bias=host(rbm.hid_bias))
    out["mse"] = rbm.cd1_update(v, h, h_pos)
    n = DBN_WITNESS_ROWS
    out.update(W_after=host(rbm.W[:n]), hid_bias_after=host(rbm.hid_bias[:n]),
               vis_bias_after=host(rbm.vis_bias))
    return out


def top_witness_step(rbms, w, b, x_all, y_all) -> dict:
    """The DBN's first fine-tuning minibatch (`train_frmshuff`'s first
    draw) at its top AffineTransform: the activations entering it, the
    targets, its w and b before and b after one SGD step of the top layer
    with softmax at DBN's fine-tuning rate (the step the whole network's
    takes for that layer: its gradient depends on nothing below it), and
    the first DBN_WITNESS_ROWS // 4 rows of w after."""
    import torch
    from kaldi_tpu_torch.nnet1.nnet import Component, Nnet1, train_frmshuff
    from kaldi_tpu_torch.nnet1.train import FrameShuffler
    x, t = next(iter(FrameShuffler(x_all, y_all, DBN["ft_mb"], seed=0)))
    with torch.no_grad():
        for rbm in rbms:
            x = rbm.propagate(x)
    P, H = w.shape
    net = Nnet1([Component("AffineTransform", H, P),
                 Component("Softmax", P, P)], device=w.device)
    after, _h = train_frmshuff(net, {"0.w": w.clone(), "0.b": b.clone()}, x,
                               t, learn_rate=DBN["ft_lr"], minibatch=len(x))

    def host(a):
        return a.detach().cpu().numpy().copy()
    n = DBN_WITNESS_ROWS // 4
    return dict(x=host(x), targets=host(t), w=host(w), b=host(b),
                w_after=host(after["0.w"][:n]), b_after=host(after["0.b"]),
                learn_rate=DBN["ft_lr"])


def phase_nnet_full(card: str, ladder: dict, profile: bool = False) -> dict:
    """The nnet families at the ladder's width on phase 20's models, each
    decoded through make_hclg_flat + CsrBeamDecoder on the LDA+MLLT
    model's HCLG: (a) `train_tdnn3` at the nnet2 rung's width, held to its
    bars (<= 7.0, <= lda_mllt + 1.0); (b) `train_lstm3` at its own width,
    its WER reported, then a wide LSTM (Kaldi's nnet3 LSTM recipe width)
    card vs CPU: the forward over 8 test utterances and 4 NG-SGD train
    steps, with ms per step, frames/s and the card's idle share; (c) a
    DBN (6 x 2048 RBMs, one CD-1 epoch each) fine-tuned by
    `train_frmshuff`, decoded with alignment-count priors: every RBM's
    reconstruction error falls over its epoch and the fine-tuning raises
    the frame accuracy. Then the gather kernel at every shape these
    decodes gave it; qaffine must not launch."""
    import torch
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.nnet.train import make_egs
    from kaldi_tpu_torch.nnet1.nnet import Component, Nnet1, train_frmshuff
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    from kaldi_tpu_torch.nnet1.train import FrameShuffler
    from kaldi_tpu_torch.nnet3.configs import make_lstm_config
    from kaldi_tpu_torch.nnet3.network import Nnet3
    from kaldi_tpu_torch.nnet3.training import Nnet3TrainOpts
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.steps import nnet3_train
    from kaldi_tpu_torch.steps.tdnn import align_with_gmm

    L = ladder["models"]
    lda_m, lang, refs = L["lda"].model, L["lang"], L["refs"]
    train_l, test_l = L["train_l"], L["test_l"]
    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    secs: dict = {}
    t = time.perf_counter()
    dec, secs["graph"] = ladder_decoder(lda_m, L["arpa"], L["dopts"], "cuda")
    shapes: set = set()
    fb, nf = pad_batch([f for _u, f, _w in test_l])

    def decode_wer(ll) -> float:
        shapes.update(csr_gather_shapes(dec, ll.shape[0], ll.shape[2]))
        return wer(refs, [[lang.words.sym(x) for x in r[0]] if r else []
                          for r in dec.decode(ll, nf)])

    def hybrid_wer(am) -> float:
        return decode_wer(am.loglikes(fb))

    w_lda, w_tdnn = ladder["lda_mllt"]["wer"], ladder["tdnn"]["wer"]
    w_mono = ladder["mono"]["wer"]
    out: dict = {}

    # (a) the nnet3 TDNN at the nnet2 rung's width and options
    t = time.perf_counter()
    r3 = nnet3_train.train_tdnn3(lda_m, train_l, train_opts=Nnet3TrainOpts(
        **LADDER_NNET3), **LADDER_TDNN3)
    secs["tdnn3"] = time.perf_counter() - t
    t = time.perf_counter()
    out["tdnn3"] = hybrid_wer(r3.am)
    secs["tdnn3 decode"] = time.perf_counter() - t
    h = r3.history
    log(f"  (a) nnet3 TDNN {LADDER_TDNN3} p-norm, {r3.am.model.num_params()} "
        f"params, NG-SGD {LADDER_NNET3}: trained in {secs['tdnn3']:.3f} s "
        f"({len(h)} logged steps, loss {h[0][2]:.4f} -> {h[-1][2]:.4f}, "
        f"frame accuracy {h[-1][3]:.4f}); decode {secs['tdnn3 decode']:.3f} "
        f"s; test WER {out['tdnn3']:.2f} against phase 20's nnet2 TDNN "
        f"{w_tdnn:.2f} and lda_mllt {w_lda:.2f} | card: {card}")

    # (b) the LSTM at train_lstm3's own width
    t = time.perf_counter()
    rl = nnet3_train.train_lstm3(lda_m, train_l, train_opts=Nnet3TrainOpts(
        **LADDER_LSTM3_OPTS))
    secs["lstm3"] = time.perf_counter() - t
    t = time.perf_counter()
    out["lstm3"] = hybrid_wer(rl.am)
    secs["lstm3 decode"] = time.perf_counter() - t
    h = rl.history
    log(f"  (b) nnet3 LSTM (train_lstm3's cell 128, proj 64, 1 layer, chunk "
        f"20), {rl.am.model.num_params()} params, {LADDER_LSTM3_OPTS}: "
        f"trained in {secs['lstm3']:.3f} s (loss {h[0][2]:.4f} -> "
        f"{h[-1][2]:.4f}, frame accuracy {h[-1][3]:.4f}); decode "
        f"{secs['lstm3 decode']:.3f} s; test WER {out['lstm3']:.2f} "
        f"(prediction: below mono's {w_mono:.2f}) | card: {card}")

    # (b) the wide LSTM, card vs CPU
    t = time.perf_counter()
    P = lda_m.am.num_pdfs
    wide = make_lstm_config(train_l[0][1].shape[1], P, **WIDE_LSTM)
    nets = _nnet3_nets(wide, 11)
    xb, _nb = pad_batch([f for _u, f, _w in test_l[:WIDE_UTTS]])
    y = {}
    for d, n in nets.items():
        ts = time.perf_counter()
        with torch.no_grad():
            y[d] = n(torch.as_tensor(xb, device=d)).cpu()
        if d == "cuda":
            torch.cuda.synchronize()
        secs[f"wide forward {d}"] = time.perf_counter() - ts
    fwd_err = float((y["cuda"] - y["cpu"]).abs().max()) \
        / float(y["cpu"].abs().max())
    aligned = align_with_gmm(lda_m, train_l)
    net = nets["cpu"]
    egs = make_egs(aligned, net.left_context, net.right_context, WIDE_CHUNK)
    perm = np.resize(np.random.RandomState(0).permutation(
        len(egs["feats"])), WIDE_MB * WIDE_STEPS)
    batches = [tuple(egs[k][perm[i * WIDE_MB:(i + 1) * WIDE_MB]]
                     for k in ("feats", "targets", "weights"))
               for i in range(WIDE_STEPS)]
    wopts = Nnet3TrainOpts()
    runs = {}
    for d in ("cuda", "cpu"):
        ts = time.perf_counter()
        runs[d] = _nnet3_steps_on(nets[d], batches, wopts)
        secs[f"wide steps {d}"] = time.perf_counter() - ts
    leaf, loss = _train_errors("ng_sgd", runs["cuda"][:2], runs["cpu"][:2])
    step_s = float(np.median(runs["cuda"][2][2:]))
    frames = WIDE_MB * WIDE_CHUNK
    # the card's idle share over one more step, under torch.profiler
    from kaldi_tpu_torch.nnet3.training import (make_nnet3_optimizer,
                                                make_nnet3_train_step)
    opt = make_nnet3_optimizer(nets["cuda"], wopts, 1)
    stepf = make_nnet3_train_step(nets["cuda"], opt)
    p = nets["cuda"].params()
    stt = opt.init(p)
    bt = [torch.as_tensor(a, device="cuda") for a in batches[0]]
    busy, n_ops, by_name = device_time(lambda: stepf(p, stt, *bt))
    out["wide"] = dict(fwd_err=fwd_err, leaf=leaf, loss=loss,
                       step_ms=step_s * 1e3, frames_s=frames / step_s,
                       idle=1 - busy / step_s, ops=n_ops)
    secs["wide"] = time.perf_counter() - t
    log(f"  (b) wide LSTM {WIDE_LSTM} ({nets['cpu'].num_params()} params, "
        f"seeded init): forward of {WIDE_UTTS} test utterances [{xb.shape[0]},"
        f" {xb.shape[1]}, {xb.shape[2]}] card {secs['wide forward cuda']:.3f} "
        f"s, CPU {secs['wide forward cpu']:.3f} s, card vs CPU "
        f"{fwd_err:.3e} of max |y| (limit {WIDE_FORWARD_LIMIT}); "
        f"{WIDE_STEPS} NG-SGD steps of {WIDE_MB} chunks x {WIDE_CHUNK} "
        f"frames ({wopts}): leaves within {leaf:.3e} of their max |p|, "
        f"losses {loss:.3e} (limits {TRAIN_LIMITS['ng_sgd']}); card "
        f"{step_s * 1e3:.3f} ms/step (median of steps 3-{WIDE_STEPS}), "
        f"{frames / step_s:.1f} frames/s; one profiled step: device busy "
        f"{busy * 1e3:.3f} ms in {n_ops} device ops, idle "
        f"{100 * (1 - busy / step_s):.1f}% | card: {card}")
    if profile:
        log_profile("one wide-LSTM train step", "step", 1, busy, n_ops,
                    by_name, step_s, 15)
        log_by_kind(by_name, 1, "step")
    if not fwd_err <= WIDE_FORWARD_LIMIT:
        raise AssertionError(f"wide LSTM forward card vs CPU {fwd_err:.3e} "
                             f"> {WIDE_FORWARD_LIMIT}")

    # (c) the DBN
    t = time.perf_counter()
    xs, stats = _dbn_inputs([f for f, _p in aligned], "cuda")
    x_all = torch.cat(xs)
    y_all = torch.as_tensor(np.concatenate([p for _f, p in aligned]),
                            device="cuda").long()
    data, rbms, rbm_log = x_all, [], []
    for li in range(DBN["layers"]):
        cfg = (RbmConfig(data.shape[1], DBN["hidden"],
                         visible_type="bernoulli") if li else
               RbmConfig(data.shape[1], DBN["hidden"],
                         learning_rate=DBN["gb_lr"]))
        rbm = Rbm(cfg, seed=li, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(100 + li)
        mse = []
        for v, _t in FrameShuffler(data, y_all, DBN["rbm_mb"], seed=li):
            if li == 0 and not mse:       # the witness's CD-1 step
                rbm_w = cd1_witness_step(rbm, v, gen)
                mse.append(rbm_w["mse"])
            else:
                mse.append(rbm.cd1_step(v, gen))
        k = max(len(mse) // 10, 1)
        rbm_log.append((float(np.mean(mse[:k])), float(np.mean(mse[-k:])),
                        len(mse)))
        with torch.no_grad():
            data = rbm.propagate(data)
        rbms.append(rbm)
    del data
    secs["dbn pretrain"] = time.perf_counter() - t
    comps, params = [], {}
    for li, rbm in enumerate(rbms):
        params[f"{2 * li}.w"], params[f"{2 * li}.b"] = rbm.W, rbm.hid_bias
        comps += [Component("AffineTransform", rbm.cfg.visible_dim,
                            rbm.cfg.hidden_dim),
                  Component("Sigmoid", rbm.cfg.hidden_dim,
                            rbm.cfg.hidden_dim)]
    top = 2 * DBN["layers"]
    comps += [Component("AffineTransform", DBN["hidden"], P),
              Component("Softmax", P, P)]
    params[f"{top}.w"] = 0.1 * torch.randn(
        P, DBN["hidden"], generator=torch.Generator().manual_seed(7)) \
        .to("cuda")
    params[f"{top}.b"] = torch.zeros(P, device="cuda")
    dbn = Nnet1(comps, device="cuda")
    save_witness(DBN_WITNESS, dict(rbm=rbm_w, finetune=top_witness_step(
        rbms, params[f"{top}.w"], params[f"{top}.b"], x_all, y_all)))

    def frame_acc(p) -> float:
        with torch.no_grad():
            hit = sum(int((dbn.apply(p, x_all[i:i + 8192]).argmax(-1)
                           == y_all[i:i + 8192]).sum())
                      for i in range(0, len(y_all), 8192))
        return hit / len(y_all)

    acc0 = frame_acc(params)
    t = time.perf_counter()
    params, ft_hist = train_frmshuff(dbn, params, x_all, y_all,
                                     learn_rate=DBN["ft_lr"],
                                     minibatch=DBN["ft_mb"],
                                     num_epochs=DBN["ft_epochs"])
    secs["dbn finetune"] = time.perf_counter() - t
    acc1 = frame_acc(params)
    counts = np.bincount(y_all.cpu().numpy(), minlength=P) + 0.5
    log_prior = torch.log(torch.as_tensor(counts / counts.sum(),
                                          dtype=torch.float32, device="cuda"))
    t = time.perf_counter()
    xt, _s = _dbn_inputs([f for _u, f, _w in test_l], "cuda", stats)
    ll = torch.zeros(len(xt), fb.shape[1], P, device="cuda")
    with torch.no_grad():
        for b, x in enumerate(xt):
            ll[b, : x.shape[0]] = dbn.apply(params, x) - log_prior
    out["dbn"] = decode_wer(ll)
    secs["dbn decode"] = time.perf_counter() - t
    log(f"  (c) DBN {DBN}: {len(y_all)} frames; RBMs (reconstruction MSE, "
        f"first -> last tenth of the epoch): " + "; ".join(
            f"{i}: {a:.5f} -> {b:.5f} ({n} steps)"
            for i, (a, b, n) in enumerate(rbm_log))
        + f"; pretrained in {secs['dbn pretrain']:.3f} s; fine-tuned in "
        f"{secs['dbn finetune']:.3f} s (last minibatch per epoch: "
        + ", ".join(f"{a:.3f}" for _l, a in ft_hist)
        + f"), training frame accuracy {acc0:.4f} -> {acc1:.4f}; decode "
        f"{secs['dbn decode']:.3f} s (priors (counts + 0.5) / total, as "
        f"nnet-forward --class-frame-counts); test WER {out['dbn']:.2f} "
        f"(prediction: below mono's {w_mono:.2f}) | card: {card}")

    checks = [("tdnn3 <= 7.0", out["tdnn3"] <= LADDER_BARS["tdnn"]),
              ("tdnn3 <= lda_mllt + 1", out["tdnn3"] <= w_lda + 1.0)] + [
        (f"RBM {i} reconstruction error falls", b < a)
        for i, (a, b, _n) in enumerate(rbm_log)] + [
        ("DBN fine-tuning raises the frame accuracy", acc1 > acc0)]
    log("  " + ", ".join(f"{c} {'ok' if ok else 'FAILS'}" for c, ok in checks)
        + f"; reported: lstm3 {out['lstm3']:.2f} "
        f"{'<' if out['lstm3'] < w_mono else '>='} mono {w_mono:.2f}, dbn "
        f"{out['dbn']:.2f} {'<' if out['dbn'] < w_mono else '>='} mono")
    failed = [c for c, ok in checks if not ok]
    if failed:
        raise AssertionError(f"phase 24: {failed} fail (WERs {out})")
    if q.launches:
        raise AssertionError(f"qaffine launched {q.launches} times")
    launches = tg.launches
    log(f"  launches: gather {launches} (the three decodes), qaffine "
        f"{q.launches}; seconds by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f"; phase 24 took {time.perf_counter() - t0:.3f} s")
    g_times = gather_at_shapes(tg, sorted(shapes), "the nnet families'", 6)
    return dict(out, launches=launches, gather_times=g_times, secs=secs)


# the speaker-recognition path: tests/test_sre_pipeline.py's corpus and
# options (phase 25), sre10's widths on a ladder_synth corpus (phase 26)
SRE_SMALL = {"v1": dict(num_gauss=8, ivector_dim=8, use_vad=False),
             "v2": dict(num_gauss=4, ivector_dim=8, use_vad=False)}
# egs/sre10/v1: a 2048-gaussian full-covariance UBM, 600-dim i-vectors;
# 200 speakers of 6 training, 1 enrollment and 1 test utterance (with 100,
# v1's PLDA EER was 41.68% against 200's 13.48%)
SRE = dict(seed=23, speakers=200, train_per_spk=6, words=(8, 17))
SRE_WIDTH = dict(num_gauss=2048, ivector_dim=600)
# phase 26's depth, and phase 40's: SrePipelineOpts' 3 UBM iterations
# per size, 4 extractor EM iterations and 8 PLDA iterations
SRE_DEPTH = dict(ubm_iters=3, ivector_iters=4, plda_iters=8)
# (i): the stages recomputed on the CPU for SRE_CHECK_UTTS utterances (8
# took 28.2 s of phase 26 beside an NVIDIA H100 80GB HBM3 at 700 W)
SRE_CHECK_UTTS = 4
SRE_CHECK_GAUSS = 64          # (i): gaussians of the M-step on the CPU
F64_EPS = 2.0 ** -53                      # f64 unit roundoff
SOLVE_C = 2.0                 # a solve's backward error: SOLVE_C (K + D) eps64


def sre_small_corpus(rng, n_spk=10, n_utt=5, frames=150, dim=8, n_comp=4):
    """tests/test_sre_pipeline.py `_make_corpus`: speakers as a 2-dim
    shift of 4 component means -> ({spk: [(feats [frames, dim], comps)]},
    component means)."""
    comp_means = rng.randn(n_comp, dim) * 4.0
    spk_dirs = rng.randn(2, dim)
    data = {}
    for s in range(n_spk):
        shift = rng.randn(2) @ spk_dirs * 1.2
        utts = []
        for _u in range(n_utt):
            comps = rng.randint(0, n_comp, frames)
            x = comp_means[comps] + shift + rng.randn(frames, dim)
            utts.append((x.astype(np.float64), comps))
        data[f"spk{s}"] = utts
    return data, comp_means


def sre_small_split(data) -> tuple:
    """tests/test_sre_pipeline.py `_split`: 3 training utterances, the
    4th enrolls, the 5th tests; every enrollment against every test."""
    train = {s: [f for (f, _c) in us[:3]] for s, us in data.items()}
    enroll = {s: us[3][0] for s, us in data.items()}
    test = {f"{s}_t": us[4][0] for s, us in data.items()}
    trials = [(s, f"{t}_t", s == t) for s in data for t in data]
    return train, enroll, test, trials


def sre_oracle_post_fn(comp_means):
    """tests/test_sre_pipeline.py's oracle 'DNN': soft assignment of each
    frame to the true component means."""
    def post_fn(feats):
        d = ((feats[:, None, :] - comp_means[None]) ** 2).sum(-1)
        e = np.exp(-0.5 * (d - d.min(axis=1, keepdims=True)))
        return e / e.sum(axis=1, keepdims=True)
    return post_fn


def sre_corpus(seed: int, speakers: int, train_per_spk: int, words,
               n_words: int = 120, n_phones: int = 30, noise: float = 70.0,
               coart: float = 0.6) -> dict:
    """`ladder_corpus`'s vocabulary, phones and synthesis (8 kHz, noise 70,
    coart 0.6) for `speakers` speakers, each with a warp from
    uniform(0.88, 1.12) and a tilt from uniform(-0.5, 0.5) and
    train_per_spk + 2 utterances of `words` words: -> dict(train {spk:
    [wave]}, enroll {spk: wave}, test {spk + "_t": wave})."""
    rng = np.random.RandomState(seed)
    lex_text, vocab = ladder_vocab(rng, n_words, n_phones)
    lexicon = {ln.split()[0]: [int(p[1:]) for p in ln.split()[1:]]
               for ln in lex_text.splitlines()}
    mel = 1127.0 * np.log1p(np.array([300.0, 3400.0]) / 700.0)
    freqs = 700.0 * np.expm1(np.linspace(mel[0], mel[1], n_phones) / 1127.0)
    spks = [f"s{k:03d}" for k in range(speakers)]
    warps = {s: rng.uniform(0.88, 1.12) for s in spks}
    tilts = {s: rng.uniform(-0.5, 0.5) for s in spks}

    def utt(spk):
        ws = [vocab[rng.randint(n_words)] for _ in range(rng.randint(*words))]
        return ladder_synth([p for w in ws for p in lexicon[w]], freqs, rng,
                            warps[spk], noise, coart, tilts[spk])

    out = dict(train={}, enroll={}, test={})
    for s in spks:
        out["train"][s] = [utt(s) for _ in range(train_per_spk)]
        out["enroll"][s] = utt(s)
        out["test"][s + "_t"] = utt(s)
    return out


def sre_mfcc_opts():
    """sre10's conf/mfcc.conf as the port's options: 8 kHz, 25 ms
    frames, 20 cepstra with energy, mel bins from 20 to 3700 Hz; no
    dither (a seeded run)."""
    from kaldi_tpu_torch.ops.features import MfccOpts
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    return MfccOpts(frame_opts=FrameOpts(samp_freq=GMM_SR, dither=0.0,
                                         frame_length_ms=25.0),
                    mel_opts=MelOpts(low_freq=20.0, high_freq=3700.0),
                    num_ceps=20)


def sre_feats(waves, device, raw: bool = False, batch: int = 200) -> list:
    """Features of 8 kHz waves on `device`, each cut to its own frames:
    sre10's MFCC + delta + delta-delta (60 dims; the deltas per
    utterance), or with raw=True the ladder's 13-dim MFCC (the LDA+MLLT
    model's input). Host arrays."""
    import torch
    from kaldi_tpu_torch.ops.delta import add_deltas
    from kaldi_tpu_torch.ops.features import mfcc
    opts = sre_mfcc_opts()
    out = []
    for i in range(0, len(waves), batch):
        ws = waves[i:i + batch]
        wb = np.zeros((len(ws), max(len(w) for w in ws)), np.float32)
        for j, w in enumerate(ws):
            wb[j, : len(w)] = w
        f = (_mfcc(wb, device) if raw else
             mfcc(torch.as_tensor(wb, device=device), opts))
        for j, w in enumerate(ws):
            fj = f[j, : max(0, (len(w) - 200) // 80 + 1)]
            out.append((fj if raw else add_deltas(fj, order=2, window=2))
                       .cpu().numpy())
    return out




def _gamma_n(n: int, u: float) -> float:
    """gamma_n = n u / (1 - n u): the relative error bound of a sum or an
    inner product of n terms in a precision of unit roundoff u."""
    return n * u / (1.0 - n * u)


def diag_ubm_stats_card_vs_cpu(gmm, x, card: str = "cuda") -> dict:
    """`AccumDiagGmm.accumulate_batch` of frames x [T, D] (as f32) with the
    DiagGmm `gmm` on the card and on the CPU, held to the bound their f32
    loglikes' difference sets: each posterior moves by at most
    `softmax_shift_bound` b of the two devices' component loglikes, each
    statistic by the sum of those moves times its frame term (1, |x|,
    x^2), plus each side's rounding of its f32 sums over a chunk of n
    frames, gamma_n(eps32) of its terms, and of the f64 sum of the chunks.
    -> {"occ", "mean", "var": largest difference over its bound, "ll": the
    loglikes' largest difference}. `card` names the device held against
    the CPU."""
    import inspect

    import torch
    from kaldi_tpu_torch.gmm.am_gmm import _augment
    from kaldi_tpu_torch.gmm.estimation import (AccumDiagGmm,
                                                _aligned_posteriors)
    x = np.asarray(x, np.float32)
    T = len(x)
    chunk = inspect.signature(AccumDiagGmm.accumulate_batch).parameters[
        "chunk"].default
    acc, ll = {}, {}
    for k, d in (("cpu", "cpu"), ("card", card)):
        xd = torch.as_tensor(x, device=d)
        acc[k] = AccumDiagGmm(gmm.num_gauss, gmm.dim)
        acc[k].accumulate_batch(gmm, xd)
        ll[k] = (_augment(xd) @ torch.as_tensor(gmm.packed(), device=d)
                 ).cpu().numpy().astype(np.float64)
    post = _aligned_posteriors(
        torch.as_tensor(x), torch.zeros(T, dtype=torch.int64),
        torch.ones(T), torch.as_tensor(gmm.packed()),
        torch.zeros(gmm.num_gauss, dtype=torch.int64))[0].numpy()
    post = post.astype(np.float64)
    b, _spread = softmax_shift_bound(ll["cpu"], ll["card"], post,
                                     np.ones(post.shape, bool))
    r = _gamma_n(min(T, chunk), F32_EPS) + _gamma_n(-(-T // chunk),
                                                   F64_EPS)
    xa = np.abs(x.astype(np.float64))
    errs = {}
    for k, a, term in (("occ", "occ", np.ones((T, 1))),
                       ("mean", "mean_acc", xa), ("var", "var_acc", xa * xa)):
        bound = (1.0 + r) * (b.T @ term) + 2.0 * r * (post.T @ term)
        errs[k] = _worst(getattr(acc["card"], a).reshape(bound.shape),
                         getattr(acc["cpu"], a).reshape(bound.shape), bound)
    errs["ll"] = float(np.abs(ll["card"] - ll["cpu"]).max())
    return errs


def full_ubm_stats_card_vs_cpu(gmm, x, card: str = "cuda") -> dict:
    """`AccumFullGmm.accumulate_batch` of frames x [T, D] with the FullGmm
    `gmm` on the card and on the CPU, held to the bound their f32 loglikes'
    difference sets (each side casts its f64 GEMM's loglikes to f32): each
    posterior moves by at most `softmax_shift_bound` b, each statistic (the
    posteriors' f64 GEMM against `full_features` [1, x, x_d x_e]) by b^T
    |f|, plus each side's f64 rounding, gamma_{T+2} of p^T |f|. -> {"occ",
    "mean", "cov": largest difference over its bound, "ll": the loglikes'
    largest difference}."""
    import torch
    from kaldi_tpu_torch.gmm.full_gmm import AccumFullGmm, full_features
    x = np.asarray(x, np.float64)
    T, D = x.shape
    acc, ll = {}, {}
    for k, d in (("cpu", "cpu"), ("card", card)):
        acc[k] = AccumFullGmm(gmm.num_gauss, gmm.dim)
        acc[k].accumulate_batch(gmm, x, device=d)
        ll[k] = gmm.loglikes_batch(x, d).cpu().numpy().astype(np.float64)
    post = gmm.posteriors_batch(x, "cpu").numpy().astype(np.float64)
    b, _spread = softmax_shift_bound(ll["cpu"], ll["card"], post,
                                     np.ones(post.shape, bool))
    f = np.abs(full_features(torch.as_tensor(x)).numpy())
    bound = (b + 2.0 * _gamma_n(T + 2, F64_EPS) * post).T @ f
    rows, cols = np.triu_indices(D)
    cov = np.zeros((gmm.num_gauss, D, D))
    cov[:, rows, cols] = bound[:, 1 + D:]
    cov[:, cols, rows] = bound[:, 1 + D:]
    errs = {k: _worst(getattr(acc["card"], a), getattr(acc["cpu"], a), bd)
            for k, a, bd in (("occ", "occ", bound[:, 0]),
                             ("mean", "mean_acc", bound[:, 1:1 + D]),
                             ("cov", "cov_acc", cov))}
    errs["ll"] = float(np.abs(ll["card"] - ll["cpu"]).max())
    return errs


def gselect_posterior_bound(ll_a, ll_b, post_a, post_b, num_gselect: int,
                            min_post: float) -> dict:
    """The bound on |post_b - post_a| of two sides' gselect / min-post
    posteriors [N, I] (`_gselect_posteriors`, JAX's `frame_posteriors`)
    from their f32 diag loglikes ll_a, ll_b [N, I] (as f64). Per frame,
    with the same top-k set on both: the softmax within it moves by
    `softmax_shift_bound`, b; the renormalization after min-post pruning
    by (b + p sum b) / s. A frame whose top-k set differs (which its k-th
    and (k+1)-th loglikes may do only where they lie within twice the
    loglikes' difference) or whose pruning differs (a posterior within b
    of min_post) may move entirely: max(p_a, p_b). -> {"bound" [N, I],
    "whole" [N] (frames of the second kind), "unjustified" (such frames
    without that margin), "near" (entries whose support differs and whose
    posterior lies within b of min_post)}."""
    top = {s: np.sort(np.argsort(-ll, axis=1, kind="stable")
                      [:, :min(num_gselect, ll.shape[1])], axis=1)
           for s, ll in (("a", ll_a), ("b", ll_b))}
    k = top["a"].shape[1]
    sel = np.zeros(ll_a.shape, bool)
    np.put_along_axis(sel, top["a"], True, axis=1)
    m = np.where(sel, ll_a, -np.inf)
    pre = np.exp(m - m.max(axis=1, keepdims=True))
    pre /= pre.sum(axis=1, keepdims=True)
    b, _spread = softmax_shift_bound(ll_a, ll_b, pre, sel)
    kept = sel & (pre >= min_post)
    s = np.maximum(np.where(kept, pre, 0.0).sum(axis=1, keepdims=True),
                   1e-300)
    p_fin = np.where(kept, pre / s, 0.0)
    bound = np.where(kept, (b + p_fin * np.where(kept, b, 0.0).sum(
        axis=1, keepdims=True)) / s, 0.0)
    bound += 2.0 * (k + 3) * F32_EPS * p_fin + 2.0 ** -126
    set_flip = np.any(top["a"] != top["b"], axis=1)
    support = sel & ((post_b > 0) != (post_a > 0))
    prune_flip = np.any(support, axis=1) & ~set_flip
    srt = -np.sort(-ll_a, axis=1)
    delta = np.abs(ll_b - ll_a).max(axis=1)
    gap = (srt[:, k - 1] - srt[:, k]) if k < srt.shape[1] else \
        np.full(len(ll_a), np.inf)
    near_entry = support & (np.abs(pre - min_post) <= b)
    near = np.any(sel & (np.abs(pre - min_post) <= b), axis=1)
    unjustified = int(np.sum(set_flip & (gap > 2.0 * delta))
                      + np.sum(prune_flip & ~near))
    whole = set_flip | prune_flip
    bound = np.where(whole[:, None], np.maximum(post_a, post_b) + 2.0 ** -126,
                     bound)
    return {"bound": bound, "whole": whole, "unjustified": unjustified,
            "near": int(near_entry.sum())}


def gselect_stats_card_vs_cpu(ext, feats_list, num_gselect: int,
                              min_post: float = 0.025,
                              card: str = "cuda") -> dict:
    """`IvectorExtractor.batch_stats` of the utterances on the card and on
    the CPU, held to the bound the devices' f32 diag loglikes set on the
    posteriors (`gselect_posterior_bound`). Each statistic moves by the sum of its frames' bounds (times |x| for X) plus each
    side's f64 rounding, gamma_{T+1} of its terms. -> {"post", "gamma",
    "X": largest difference over its bound, "flips": frames of the second
    kind, "unjustified": flips without that margin, "stats": the CPU's
    (gamma, X)}."""
    import torch
    from kaldi_tpu_torch.gmm.am_gmm import _augment
    from kaldi_tpu_torch.ivector.extractor import _gselect_posteriors
    packed = ext._gselect_gmm().packed()
    x = np.concatenate([np.asarray(f, np.float64) for f in feats_list])
    ll, post = {}, {}
    for d in ("cpu", card):
        xd = torch.as_tensor(x, dtype=torch.float32, device=d)
        pk = torch.as_tensor(packed, device=d)
        ll[d] = (_augment(xd) @ pk).cpu().numpy().astype(np.float64)
        post[d] = _gselect_posteriors(xd, pk, num_gselect,
                                      min_post).cpu().numpy()
    gb = gselect_posterior_bound(ll["cpu"], ll[card], post["cpu"], post[card],
                                 num_gselect, min_post)
    bound, whole = gb["bound"], gb["whole"]
    g_card, X_card = (t.cpu().numpy() for t in ext.batch_stats(
        feats_list, num_gselect, min_post, device=card))
    g_cpu, X_cpu = (t.numpy() for t in ext.batch_stats(
        feats_list, num_gselect, min_post, device="cpu"))
    errs = {"post": _worst(post[card], post["cpu"], bound),
            "flips": int(whole.sum()), "unjustified": gb["unjustified"],
            "gamma": 0.0, "X": 0.0}
    xa = np.abs(x)
    t = 0
    for n, f in enumerate(feats_list):
        T = len(f)
        bt, pt, at = bound[t:t + T], post["cpu"][t:t + T], xa[t:t + T]
        r = 2.0 * _gamma_n(T + 1, F64_EPS)
        errs["gamma"] = max(errs["gamma"], _worst(
            g_card[n], g_cpu[n], bt.sum(0) + r * pt.sum(0)))
        errs["X"] = max(errs["X"], _worst(
            X_card[n], X_cpu[n], bt.T @ at + r * (pt.T @ at)))
        t += T
    return dict(errs, stats=(g_cpu, X_cpu))


def backward_error(A, X, B) -> np.ndarray:
    """The backward error of solves X A = B, per matrix: |X A - B| / (|X|
    |A|) (Frobenius) for A [G, K, K], X and B [G, D, K] f64. Its bound,
    `backward_bound`, is SOLVE_C (K + D) eps64: the residual's own f64
    rounding is at most K eps64 of |X| |A|, and a Cholesky solve's
    backward error is a small multiple of K eps64 in practice (Higham,
    Accuracy and Stability of Numerical Algorithms, 10.1; its worst case,
    3 K^2 eps64, is a bound nothing reaches). An M-step's M that differs
    from the solve by 1e-9 of itself exceeds it
    (tests/test_torch_ivector.py)."""
    res = X @ A - B
    return (np.linalg.norm(res.reshape(len(X), -1), axis=1)
            / np.maximum(np.linalg.norm(X.reshape(len(X), -1), axis=1)
                         * np.linalg.norm(A.reshape(len(X), -1), axis=1),
                         1e-300))


def backward_bound(K: int, D: int) -> float:
    return SOLVE_C * (K + D) * F64_EPS


def mstep_backward_error(M, A, B, smooth: float) -> tuple:
    """The M-step's backward error per gaussian, |M_i (A_i + s I) - B_i| /
    (|M_i| |A_i + s I|), for M [G, D, K], A [G, K, K], B [G, D, K] f64,
    and its bound (`backward_error`). -> (errors [G], bound)."""
    K, D = A.shape[-1], M.shape[1]
    return (backward_error(A + smooth * np.eye(K), M, B),
            backward_bound(K, D))


def extractor_step_card_vs_cpu(ext, gamma, X, gauss=None,
                               card: str = "cuda") -> dict:
    """One E-step and M-step of the batch path from the same stats (gamma
    [N, I], X [N, I, D], host f64) on the card and on the CPU, the M-step's
    statistics and M over the gaussians `gauss` (all by default). Norms
    are 2-norms of vectors and symmetric matrices, Frobenius of the rest;
    every bound is per utterance or per gaussian:
    - the linear system: L = I + sum_i gamma_i U_i and b = sum_i V_i Xc_i
      (+ the prior offset) differ by at most both sides' rounding of them
      from M: with U_i = (Sigma_i^-1 M_i)^T M_i and V_i^T = Sigma_i^-1 M_i
      in D-term inner products, |dU_i| <= gamma_D |M_i| (|V_i| +
      |Sigma_i^-1| |M_i|), |dL| <= sum_i gamma_i (|dU_i| + gamma_I |U_i|)
      + eps |L|, and |db| <= sum_i (gamma_{ID} |V_i| |Xc_i| + |dXc_i|
      |V_i| + |Xc_i| gamma_D |Sigma_i^-1| |M_i|) + eps |b| with |dXc_i|
      <= eps (|X_i| + 2 gamma_i |mu_i|);
    - the solves: with r = L w - b each side's residual (measured in f64,
      plus its own rounding gamma_{K+1} (|L| |w| + |b|)), w_card - w_cpu
      = L_cpu^-1 (db - dL w_card + r_card - r_cpu), so |dw| <= |L_cpu^-1|
      (|dL| |w_card| + |db| + |r_card| + |r_cpu|); the same for L^-1
      with R = L L^-1 - I: |dL^-1| <= |L_cpu^-1| (|dL| |L^-1_card| +
      |R_card| + |R_cpu|). That is kappa(L) times the measured
      differences and residuals, and as loose as kappa(L) is large; each
      side's solves (L w = b, L L^-1 = I; L symmetric) are also held by
      their backward error (`backward_error`);
    - the statistics: A_i = sum_n gamma_ni E_n[w w^T] and B_i = sum_n
      Xc_ni w_n^T differ by at most what the measured differences of
      E[w w^T], Xc and w carry into them, plus each side's rounding,
      gamma_{N+1} of their terms (and 4 eps of E[w w^T] for its sum);
    - the M-step: each side's M_i by its backward error against its own
      statistics (`mstep_backward_error`). The difference of the two M is
      reported, not held: with few utterances kappa(A_i + sI) reaches 1e9.
    -> {"L", "b", "w", "Linv", "solve", "A", "B", "M": the largest ratio
    of each to its bound, "kappa_L", "kappa_A": the largest condition numbers,
    "w_rel", "M_rel": the largest relative differences, "M_backward": the
    largest backward error, "finite": every tensor of both steps finite}.
    `card` names the device held against the CPU."""
    import inspect

    import torch
    from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                                   IvectorStats)
    I, D, K = ext.M.shape
    N = len(gamma)
    gauss = np.arange(I) if gauss is None else np.asarray(gauss)
    smooth = inspect.signature(IvectorStats.update).parameters[
        "smoothing"].default
    side, finite = {}, True
    for key, d in (("card", card), ("cpu", "cpu")):
        e = IvectorExtractor.from_arrays(ext.means, ext.inv_covars,
                                         ext.weights, ext.M,
                                         ext.prior_offset)
        g = torch.as_tensor(gamma, device=d)
        Xd = torch.as_tensor(X, device=d)
        L, b, xc = e.linear_terms(g, Xd)
        _iv, w, chol, _xc = e.posterior_batch(g, Xd)
        st = IvectorStats(e, d)
        st.accumulate_batch(e, g, Xd)
        out = {"L": L, "b": b, "w": w, "Linv": torch.cholesky_inverse(chol),
               "xc": xc[:, gauss], "xcn": torch.linalg.vector_norm(xc, dim=2),
               "A": st.A[gauss], "B": st.B[gauss]}
        if key == "cpu":
            c = e.on_device("cpu")

            def fro(t):
                return torch.linalg.vector_norm(t.flatten(1), dim=1)
            out.update(nM=fro(c["M"]), nVt=fro(c["Vt"]), nU=fro(c["U"]),
                       nic=fro(torch.as_tensor(ext.inv_covars)))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        sub = IvectorExtractor.from_arrays(
            ext.means[gauss], ext.inv_covars[gauss], ext.weights[gauss],
            ext.M[gauss], ext.prior_offset)
        sst = IvectorStats(sub, d)
        sst.A, sst.B = st.A[gauss], st.B[gauss]
        sst.update(sub)
        out["M"] = sub.M
        finite &= all(bool(np.isfinite(out[k]).all())
                      for k in ("w", "Linv", "A", "B", "M"))
        side[key] = out
        del st, sst, e
    c, p = side["card"], side["cpu"]
    eps = F64_EPS

    def fro(a):
        return np.linalg.norm(a.reshape(len(a), -1), axis=1)

    def vec(a):
        return np.linalg.norm(a, axis=-1)

    def spec(a):
        return np.linalg.norm(a, ord=2, axis=(1, 2))

    gm = np.asarray(gamma, np.float64)
    eL = np.linalg.eigvalsh(p["L"])
    linv_norm, kL = 1.0 / eL[:, 0], eL[:, -1] / eL[:, 0]
    # the linear system's forward bounds
    dVt = _gamma_n(D, eps) * p["nic"] * p["nM"]
    dU = _gamma_n(D, eps) * p["nM"] * (p["nVt"] + p["nic"] * p["nM"])
    bL = 2.0 * (gm @ (dU + _gamma_n(I, eps) * p["nU"]) + eps * fro(p["L"]))
    mun = vec(ext.means)
    dXc = eps * (vec(np.asarray(X, np.float64)) + 2.0 * gm * mun)
    bb = 2.0 * ((_gamma_n(I * D, eps) * p["xcn"] * p["nVt"]
                 + dXc * p["nVt"] + p["xcn"] * dVt).sum(axis=1)
                + eps * vec(p["b"]))
    dL, db = spec(c["L"] - p["L"]), vec(c["b"] - p["b"])

    # the solves, from each side's residuals
    def resid(s):
        r = vec(np.einsum("nkj,nj->nk", s["L"], s["w"]) - s["b"])
        r += _gamma_n(K + 1, eps) * (fro(s["L"]) * vec(s["w"]) + vec(s["b"]))
        R = spec(s["L"] @ s["Linv"] - np.eye(K))
        R += _gamma_n(K, eps) * fro(s["L"]) * fro(s["Linv"])
        return r, R

    (rc, Rc), (rp, Rp) = resid(c), resid(p)
    # each side's solves by their backward error, as the M-step's
    solve_back = max(float(backward_error(
        s["L"], x, y).max()) for s in (c, p) for x, y in (
        (s["w"][:, None], s["b"][:, None]),
        (s["Linv"], np.broadcast_to(np.eye(K), s["L"].shape))))
    dw = vec(c["w"] - p["w"])
    bw = linv_norm * (dL * vec(c["w"]) + db + rc + rp)
    dLinv = spec(c["Linv"] - p["Linv"])
    bLinv = linv_norm * (dL * spec(c["Linv"]) + Rc + Rp)
    # the statistics
    g_n = _gamma_n(N + 1, eps)
    eww = {k: s["Linv"] + s["w"][:, :, None] * s["w"][:, None, :]
           for k, s in (("c", c), ("p", p))}
    mag = np.maximum(fro(c["Linv"]), fro(p["Linv"])) + np.maximum(
        vec(c["w"]), vec(p["w"])) ** 2
    gg = gm[:, gauss]                                          # [N, G]
    bA = gg.T @ (fro(eww["c"] - eww["p"]) + 2.0 * (g_n + 4.0 * eps) * mag)
    xcg = np.linalg.norm(p["xc"], axis=2)                      # [N, G]
    wn = np.maximum(vec(c["w"]), vec(p["w"]))
    bB = (np.linalg.norm(c["xc"] - p["xc"], axis=2).T @ wn + xcg.T @ dw
          + 2.0 * g_n * (xcg.T @ wn))
    back = {k: mstep_backward_error(s["M"], s["A"], s["B"], smooth)
            for k, s in (("card", c), ("cpu", p))}
    evA = np.linalg.eigvalsh(p["A"] + smooth * np.eye(K))
    # a gaussian no frame of these utterances reached has M_i = 0 on both
    M_rel = fro(c["M"] - p["M"]) / np.maximum(fro(p["M"]), 1e-300)

    def ratio(diff, bound):
        return float(np.max(diff / np.maximum(bound, 1e-300)))
    return {"L": ratio(fro(c["L"] - p["L"]), bL), "b": ratio(db, bb),
            "w": ratio(dw, bw), "Linv": ratio(dLinv, bLinv),
            "A": ratio(fro(c["A"] - p["A"]), bA),
            "B": ratio(fro(c["B"] - p["B"]), bB),
            "solve": solve_back / backward_bound(K, D),
            "M": max(float(v[0].max() / v[1]) for v in back.values()),
            "M_backward": float(back["card"][0].max()),
            "kappa_L": float(kL.max()),
            "kappa_A": float((evA[:, -1] / evA[:, 0]).max()),
            "w_rel": float((dw / vec(p["w"])).max()),
            "M_rel": float(M_rel.max()), "finite": finite}


EXTRACTOR_CHECKS = (("L", "E-step L"), ("b", "E-step b"), ("w", "E-step w"),
                    ("Linv", "E-step L^-1"),
                    ("solve", "E-step solves' backward error"),
                    ("A", "M-step statistic A"),
                    ("B", "M-step statistic B"),
                    ("M", "M-step backward error"))


def check_extractor_step(check, what: str, es: dict) -> str:
    """Hold `extractor_step_card_vs_cpu`'s ratios to 1 and its tensors
    finite. -> a line for the log with each ratio."""
    for k, name in EXTRACTOR_CHECKS:
        check(f"{what}: {name} over its bound", es[k], 1.0)
    check.require(f"{what}: an E/M-step tensor is not finite", es["finite"])
    return (", ".join(f"{name} {es[k]:.3e}" for k, name in EXTRACTOR_CHECKS)
            + f" of their bounds (kappa(L) up to {es['kappa_L']:.3e}, w "
            f"{es['w_rel']:.3e} relative; M-step backward error "
            f"{es['M_backward']:.3e}; M card vs CPU {es['M_rel']:.3e} "
            f"relative, reported: kappa(A + sI) up to {es['kappa_A']:.3e})")


def check_ubm_stats(check, what: str, du: dict | None, fu: dict | None,
                    gs: dict | None) -> str:
    """Hold the diag UBM's, the full UBM's and the gselect statistics'
    ratios (any of them None is skipped) to 1 and the gselect flips to
    their margin. -> a line for the log with each ratio."""
    parts = []
    if du is not None:
        for k in ("occ", "mean", "var"):
            check(f"{what}: diag UBM {k} over its bound", du[k], 1.0)
        parts.append("diag UBM occ/mean/var " + "/".join(
            f"{du[k]:.3e}" for k in ("occ", "mean", "var"))
            + f" of their bounds (f32 loglikes apart by {du['ll']:.3e})")
    if fu is not None:
        for k in ("occ", "mean", "cov"):
            check(f"{what}: full UBM {k} over its bound", fu[k], 1.0)
        parts.append("full UBM occ/mean/cov " + "/".join(
            f"{fu[k]:.3e}" for k in ("occ", "mean", "cov"))
            + f" (f32 loglikes apart by {fu['ll']:.3e})")
    if gs is not None:
        for k in ("post", "gamma", "X"):
            check(f"{what}: gselect {k} over its bound", gs[k], 1.0)
        check(f"{what}: gselect flips without a margin", gs["unjustified"],
              0)
        parts.append("gselect posteriors/gamma/X " + "/".join(
            f"{gs[k]:.3e}" for k in ("post", "gamma", "X"))
            + f", {gs['flips']} frames with another selection or pruning "
            f"(each within its loglikes' difference of the tie)")
    return "; ".join(parts)


def _trial_scores(scores: dict, trials) -> tuple[list, list]:
    tgt = [scores[(e, t)] for e, t, y in trials if y]
    non = [scores[(e, t)] for e, t, y in trials if not y]
    return tgt, non


def vad_card_vs_cpu(waves) -> dict:
    """`compute_vad` of sre10's features of `waves` from the card and from
    the CPU: a frame's decision may differ only where its log-energy lies
    within the two devices' largest log-energy difference (times 1.5, the
    threshold's mean term moving too) of the threshold. -> {"frames",
    "voiced", "flips", "unjustified", "margin": the smallest distance of a
    log-energy from its threshold}."""
    from kaldi_tpu_torch.ivector.vad import VadOpts, compute_vad
    o = VadOpts()
    fs = {d: sre_feats(waves, d) for d in ("cpu", "cuda")}
    out = {"frames": 0, "voiced": 0, "flips": 0, "unjustified": 0,
           "margin": np.inf}
    for a, b in zip(fs["cpu"], fs["cuda"]):
        ma, mb = compute_vad(a, o), compute_vad(b, o)
        e = a[:, 0].astype(np.float64)
        dist = np.abs(e - o.vad_energy_threshold
                      - o.vad_energy_mean_scale * e.mean())
        d = float(np.abs(b[:, 0].astype(np.float64) - e).max())
        flip = ma != mb
        out["frames"] += len(e)
        out["voiced"] += int(ma.sum())
        out["flips"] += int(flip.sum())
        out["unjustified"] += int(np.sum(flip & (dist > 1.5 * d)))
        out["margin"] = min(out["margin"], float(dist.min()))
    return out


def phase_sre_small():
    """tests/test_sre_pipeline.py's corpus through v1 and v2 on the card
    and on the CPU (the EERs equal), each stage's device work held to its
    derived bound from the same inputs; logistic regression and the VAD of
    the card's features against the CPU's."""
    from kaldi_tpu_torch.ivector.logistic_regression import \
        LogisticRegression
    from kaldi_tpu_torch.ivector.plda import length_normalize
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.steps import sre

    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    check = _Limits()
    data, cm = sre_small_corpus(np.random.RandomState(0))
    train, enroll, test, trials = sre_small_split(data)
    systems = {}
    for name, opts in SRE_SMALL.items():
        kw = ({} if name == "v1" else
              dict(post_fn=sre_oracle_post_fn(cm), num_post_classes=4))
        res = {}
        for d in ("cpu", "cuda"):
            st: dict = {}
            s = sre.train_sre_system(train, sre.SrePipelineOpts(**opts),
                                     device=d, stage_stats=st, **kw)
            res[d] = (s, st) + sre.evaluate_sre(s, enroll, test, trials)
        systems[name] = res
        (sc, stc, ec, scc), (sg, stg, eg, scg) = res["cpu"], res["cuda"]
        ubm = max(_rel_err(getattr(sg.ubm, f), getattr(sc.ubm, f))
                  for f in ("weights", "means", "covars"))
        iv = float(np.abs(stg["ivectors"] - stc["ivectors"]).max()
                   / np.abs(stc["ivectors"]).max())
        want = np.array([scc[k] for k in scc])
        sdiff = float(np.abs(np.array([scg[k] for k in scc]) - want).max())
        log(f"  {name}: EER card {eg * 100:.2f}% CPU {ec * 100:.2f}%; "
            f"reported, card vs CPU end to end: UBM {ubm:.3e} relative, "
            f"training i-vectors {iv:.3e} of their largest, scores "
            f"{sdiff:.3e} of {np.abs(want).max():.3f}")
        check.require(f"{name}: EER card {eg} != CPU {ec}", eg == ec)
        check.require(f"{name}: EER {ec} >= 0.15 (PARITY.md:47)", ec < 0.15)

    # each stage from the same inputs, on the CPU systems' models
    flat = [f for us in train.values() for f in us]
    pooled = np.concatenate(flat)
    s1, st1 = systems["v1"]["cpu"][:2]
    du = diag_ubm_stats_card_vs_cpu(st1["diag_gmm"], pooled)
    fu = full_ubm_stats_card_vs_cpu(s1.ubm, pooled)
    gs = gselect_stats_card_vs_cpu(s1.extractor, flat, s1.opts.num_gselect)
    log("  v1 stages card vs CPU from the same inputs: "
        + check_ubm_stats(check, "v1", du, fu, gs))
    log("  v1 E/M-step: " + check_extractor_step(
        check, "v1", extractor_step_card_vs_cpu(s1.extractor, *gs["stats"])))
    s2 = systems["v2"]["cpu"][0]
    g2, X2 = s2.stats(flat)
    log("  v2 E/M-step: " + check_extractor_step(
        check, "v2", extractor_step_card_vs_cpu(s2.extractor, g2.numpy(),
                                                X2.numpy())))

    # logistic regression on v1's training i-vectors, speaker labels
    X = length_normalize(st1["ivectors"])
    labels = np.repeat(np.arange(len(train)), 3)
    lr = {k: LogisticRegression() for k in ("cpu", "card")}
    loss = {k: lr[k].train(X, labels, device=d)
            for k, d in (("cpu", "cpu"), ("card", "cuda"))}
    lw = float(np.abs(lr["card"].weights - lr["cpu"].weights).max())
    # separable points: Adam at lr 0.5 wanders along a flat valley floor,
    # where f32 gradient noise picks the way, so the weights are reported
    # and the (convex, L2) loss and the classes held
    check("logistic regression loss card vs CPU",
          abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]), 1e-4)
    check.require("logistic regression classes card != CPU", np.array_equal(
        lr["card"].classify(X), lr["cpu"].classify(X)))

    # VAD of sre10's features from the card and from the CPU
    rng = np.random.RandomState(2)
    vd = vad_card_vs_cpu([ladder_synth(
        list(rng.randint(0, 30, 12)), np.linspace(300.0, 3400.0, 30), rng,
        1.0, 70.0, 0.6, 0.0) for _ in range(4)])
    check("VAD flips without a margin", vd["unjustified"], 0)
    check.require(f"kernels launched in phase 25 (gather {tg.launches}, "
                  f"qaffine {q.launches})", not (q.launches or tg.launches))
    log(f"  logistic regression card vs CPU: loss {loss['card']:.6f} vs "
        f"{loss['cpu']:.6f}, the same classes, weights apart by {lw:.3e} "
        f"(reported); VAD over {vd['frames']} frames ({vd['voiced']} voiced) "
        f"of the card's and the CPU's features: {vd['flips']} decisions "
        f"differ (log-energy at least {vd['margin']:.3e} from the "
        f"threshold); launches: gather {tg.launches}, qaffine {q.launches}; "
        f"phase 25 took {time.perf_counter() - t0:.3f} s")
    check.done("phase 25")


def _peak(what: str) -> str:
    import torch
    gb = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    return f"{what} {gb:.2f} GiB"


def _cosine_eer(e_iv: dict, t_iv: dict, trials) -> float:
    from kaldi_tpu_torch.ivector.metrics import compute_eer
    ek, tk = list(e_iv), list(t_iv)
    E = np.stack([e_iv[k] for k in ek])
    T = np.stack([t_iv[k] for k in tk])
    c = (E / np.linalg.norm(E, axis=1, keepdims=True)) @ \
        (T / np.linalg.norm(T, axis=1, keepdims=True)).T
    ei, ti = {k: i for i, k in enumerate(ek)}, {k: i for i, k in enumerate(tk)}
    s = {(e, t): c[ei[e], ti[t]] for e, t, _y in trials}
    return compute_eer(*_trial_scores(s, trials))[0]


def _sre_system_at_width(name: str, train, enroll, test, trials, card,
                         **kw) -> dict:
    """Train and score one sre10 system at SRE_WIDTH on the card, with
    seconds and peak memory by stage. -> dict."""
    import torch
    from kaldi_tpu_torch.steps import sre
    torch.cuda.reset_peak_memory_stats()
    st: dict = {}
    opts = sre.SrePipelineOpts(**SRE_WIDTH, **SRE_DEPTH,
                               use_vad=name == "v1")
    t = time.perf_counter()
    system = sre.train_sre_system(train, opts, device="cuda",
                                  stage_stats=st, **kw)
    train_s = time.perf_counter() - t
    mem = [_peak("training")]
    t = time.perf_counter()
    eer, scores = sre.evaluate_sre(system, enroll, test, trials)
    score_s = time.perf_counter() - t
    t = time.perf_counter()
    ivs = system.ivectors(list(enroll.values()) + list(test.values()))
    iv_s = time.perf_counter() - t
    mem.append(_peak("scoring"))
    eer_cos = _cosine_eer(dict(zip(enroll, ivs[:len(enroll)])),
                          dict(zip(test, ivs[len(enroll):])), trials)
    ll = [s["loglike"] for s in st["ubm_iters"]]
    log(f"  {name}: {system.ubm.num_gauss} gaussians, {opts.ivector_dim}-dim "
        f"i-vectors, VAD {'on' if opts.use_vad else 'off'}; seconds: "
        + (f"diag UBM {st['diag_ubm']:.3f}, full UBM "
           f"{st['ubm'] - st['diag_ubm']:.3f} (per iteration "
           + ", ".join(f"{s['secs']:.3f} = accumulation "
                       f"{s['accumulate']:.3f} + update "
                       f"{s['secs'] - s['accumulate']:.3f}"
                       for s in st["ubm_iters"] if "secs" in s) + ")"
           if name == "v1" else f"posterior UBM {st['ubm']:.3f}")
        + f", extractor init and stats {st['stats']:.3f}, EM per iteration "
        + ", ".join(f"{s:.3f}" for s in st["ivector_iters"])
        + f", training i-vectors (stats again, after a second VAD pass "
        f"when on, as in JAX) {st['train_ivectors']:.3f}, PLDA "
        f"{st['plda']:.3f}, evaluation (i-vectors + {len(trials)} trials) "
        f"{score_s:.3f} (of which {len(ivs)} i-vectors {iv_s:.3f}); whole "
        f"training {train_s:.3f}; peak memory {', '.join(mem)} | {card}")
    if ll:
        log("  " + name + ": full UBM log-likelihood per frame by iteration "
            + ", ".join(f"{v:.6f}" for v in ll))
    log(f"  {name}: EER PLDA {eer * 100:.2f}%, cosine {eer_cos * 100:.2f}% "
        f"on {sum(y for *_k, y in trials)} target and "
        f"{sum(not y for *_k, y in trials)} non-target trials (reported)")
    finite = all(np.isfinite(a).all() for a in (
        system.ubm.weights, system.ubm.means, system.ubm.covars,
        system.extractor.M, st["ivectors"], system.plda.transform,
        system.plda.psi, ivs, list(scores.values())))
    return dict(system=system, eer=eer, eer_cos=eer_cos, ll=ll,
                finite=finite, stage=st, ivectors=st["ivectors"],
                eval_ivectors=ivs)


def _width_checks(check, name: str, res: dict, flat: list):
    """(i) the stages recomputed for SRE_CHECK_UTTS utterances, card vs
    CPU from the same inputs, each within its bound: for v1 the diag UBM's
    and the full UBM's statistics and the gselect stats; then one E-step
    and the M-step (over SRE_CHECK_GAUSS gaussians) from those stats;
    (ii) the full UBM's log-likelihood per frame never falls by more than
    1e-6 relative; (iii) every tensor finite."""
    system = res["system"]
    ext = system.extractor
    utts = [system.voiced(f) for f in flat[:SRE_CHECK_UTTS]]
    t = time.perf_counter()
    if system.post_fn is None:
        x = np.concatenate(utts)
        gs = gselect_stats_card_vs_cpu(ext, utts, system.opts.num_gselect)
        text = check_ubm_stats(
            check, f"{name} (i)",
            diag_ubm_stats_card_vs_cpu(res["stage"]["diag_gmm"], x),
            full_ubm_stats_card_vs_cpu(system.ubm, x), gs) + "; "
        stats = gs["stats"]
    else:
        g, X = system.stats(utts)
        stats, text = (g.cpu().numpy(), X.cpu().numpy()), ""
    I = ext.M.shape[0]
    gauss = np.linspace(0, I - 1, min(SRE_CHECK_GAUSS, I)).astype(int)
    es = extractor_step_card_vs_cpu(ext, *stats, gauss=gauss)
    text += "E/M-step " + check_extractor_step(check, f"{name} (i)", es)
    ll = res["ll"]
    fall = max([(a - b) / abs(a) for a, b in zip(ll, ll[1:])], default=0.0)
    check(f"{name} (ii): full UBM log-likelihood falls", fall, 1e-6)
    check.require(f"{name} (iii): a tensor is not finite", res["finite"])
    log(f"  {name} (i) card vs CPU for {len(utts)} utterances "
        f"({sum(len(u) for u in utts)} frames), the M-step over "
        f"{len(gauss)} gaussians: {text}; in {time.perf_counter() - t:.3f} "
        f"s; (ii) largest fall of the UBM log-likelihood {fall:.3e}; (iii) "
        f"finite {res['finite']}")


def phase_sre_full(card: str, ladder: dict) -> dict:
    """sre10 v1 and v2 at SRE_WIDTH on the card over `sre_corpus`, then
    logistic regression over v1's training i-vectors at the reference's
    options. Neither kernel may launch."""
    import torch
    from kaldi_tpu_torch.ivector.logistic_regression import (
        LogisticRegression, LogisticRegressionConfig)
    from kaldi_tpu_torch.ivector.plda import length_normalize
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.steps.lda_mllt import LdaMlltTrainOpts

    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    check = _Limits()
    t = time.perf_counter()
    corpus = sre_corpus(**SRE)
    synth_s = time.perf_counter() - t
    spks = list(corpus["train"])
    waves = ([w for s in spks for w in corpus["train"][s]]
             + list(corpus["enroll"].values()) + list(corpus["test"].values()))
    t = time.perf_counter()
    feats = sre_feats(waves, "cuda")
    feat_s = time.perf_counter() - t
    n_tr = len(spks) * SRE["train_per_spk"]
    train = {s: feats[i * SRE["train_per_spk"]:(i + 1) * SRE["train_per_spk"]]
             for i, s in enumerate(spks)}
    enroll = dict(zip(corpus["enroll"], feats[n_tr:n_tr + len(spks)]))
    test = dict(zip(corpus["test"], feats[n_tr + len(spks):]))
    trials = [(e, t, e + "_t" == t) for e in enroll for t in test]
    frames = sum(len(f) for f in feats[:n_tr])
    log(f"  corpus: {len(spks)} speakers, {n_tr} training utterances "
        f"({frames} frames, {frames / 100 / n_tr:.2f} s each on average), "
        f"{len(enroll)} enrollment and {len(test)} test; synthesized in "
        f"{synth_s:.3f} s, sre10 MFCC + deltas ({feats[0].shape[1]} dims) on "
        f"the card in {feat_s:.3f} s")
    flat = [f for s in spks for f in train[s]]
    log("  cut from egs/sre10: speakers and hours (sre10 trains on "
        f"thousands of speakers; here {len(spks)} synthetic ones) and, for "
        "v2, the DNN (phase 20's 166 pdfs against about 5,000 senones); not "
        "cut: "
        "the 2048-gaussian UBM, the 600-dim i-vectors, the 60-dim features")

    out = {}
    # (a) v1: GMM-UBM with VAD
    out["v1"] = _sre_system_at_width("v1", train, enroll, test, trials, card)
    _width_checks(check, "v1", out["v1"], flat)

    # (b) v2: phase 20's TDNN posteriors over the LDA+MLLT model's pdfs on
    # the same utterances' ASR features (same frame shift and edges)
    models = ladder["models"]
    lda, nnet = models["lda"], models["nnet"]
    lopts = LdaMlltTrainOpts(**LADDER_LDA)
    t = time.perf_counter()
    raw = sre_feats(waves, "cuda", raw=True)
    posts = {}
    for f, r in zip(feats, raw):
        if len(r) != len(f):
            raise AssertionError(f"ASR frames {len(r)} != SRE {len(f)}")
        lp = nnet.am.log_posteriors(lda.transform_feats(r, lopts))
        posts[id(f)] = torch.exp(lp.double()).cpu().numpy()
    post_s = time.perf_counter() - t
    P = nnet.am.num_pdfs
    log(f"  v2 posteriors: phase 20's TDNN over {P} pdfs on the LDA+MLLT "
        f"features of all {len(feats)} utterances in {post_s:.3f} s")
    out["v2"] = _sre_system_at_width(
        "v2", train, enroll, test, trials, card,
        post_fn=lambda f: posts[id(f)], num_post_classes=P)
    _width_checks(check, "v2", out["v2"], flat)
    for name in ("v1", "v2"):
        r = out[name]
        log(f"  {name} beside PARITY.md:46-47's bars (reported, not held at "
            f"this corpus): EER {r['eer'] * 100:.2f}% vs 15%; PLDA "
            f"{r['eer'] * 100:.2f}% vs cosine {r['eer_cos'] * 100:.2f}% + 2")

    # (c) logistic regression at the reference's options: speakers from
    # (a)'s length-normalized training i-vectors, scored on the test ones
    cfg = LogisticRegressionConfig()
    Xtr = length_normalize(out["v1"]["ivectors"])
    labels = np.repeat(np.arange(len(spks)), SRE["train_per_spk"])
    Xte = length_normalize(out["v1"]["eval_ivectors"][len(spks):])
    t = time.perf_counter()
    lr = LogisticRegression()
    loss = lr.train(Xtr, labels, cfg, device="cuda")
    lr_s = time.perf_counter() - t
    acc = float(np.mean(lr.classify(Xte) == np.arange(len(spks))))
    acc_tr = float(np.mean(lr.classify(Xtr) == labels))
    check.require(f"logistic regression: loss {loss} or weights not finite",
                  np.isfinite(loss) and np.isfinite(lr.weights).all())
    log(f"  (c) logistic regression at {cfg} over {len(Xtr)} v1 training "
        f"i-vectors, {len(spks)} speakers: final loss {loss:.6f} (the zero "
        f"model's log {len(spks)} = {np.log(len(spks)):.6f}), accuracy on "
        f"the training i-vectors {acc_tr * 100:.2f}%, closed-set accuracy on "
        f"the {len(Xte)} test i-vectors {acc * 100:.2f}%, in {lr_s:.3f} s "
        f"| {card}")
    check.require(f"kernels launched in phase 26 (gather {tg.launches}, "
                  f"qaffine {q.launches})", not (q.launches or tg.launches))
    log(f"  launches: gather {tg.launches}, qaffine {q.launches}; phase 26 "
        f"took {time.perf_counter() - t0:.3f} s")
    check.done("phase 26")
    return dict(v1_eer=out["v1"]["eer"], v2_eer=out["v2"]["eer"],
                gather_launches=tg.launches, qaffine_launches=q.launches,
                lr_loss=loss, lr_accuracy=acc)


# phase 40: egs/sre10/v1's run.sh through the CLI's files on phase 26's
# corpus. sre10's conf/mfcc.conf as the CLI takes it: 8 kHz, 25 ms
# frames, 20 cepstra over 23 mel bins from 20 Hz (its --high-freq 3700
# and --snip-edges false are not options of compute-mfcc-feats: the
# bins reach 4000 Hz and edges are snipped, as in phase 26); then
# phase 26's depth (SRE_DEPTH) with the extractor at gselect 10
SRE_CLI_MFCC = ["--sample-frequency", "8000", "--frame-length", "25",
                "--dither", "0", "--num-ceps", "20"]
SRE_CLI_GSELECT = "10"
# the steps each set's i-vectors take before scoring ("n" length
# normalization, "c" subtracting the training set's mean):
# local/plda_scoring.sh's, with the enrollment speakers' i-vectors as
# sid/extract_ivectors.sh writes them (normalized, averaged over the
# speaker's utterances, normalized again: one utterance each here)
SRE_CLI_NORM = {"train": ("c", "n"), "enroll": ("n", "c", "n"),
                "test": ("n", "c", "n")}
SRE_CLI_EER_BAR = 0.15        # PARITY.md:46's SRE bar
SRE_CLI_KIND = {
    "compute-mfcc-feats": "features", "add-deltas": "features",
    "compute-vad": "features", "select-voiced-frames": "features",
    "train-ubm": "ubm", "train-ivector-extractor": "extractor",
    "ivector-extract": "ivectors", "ivector-mean": "ivectors",
    "ivector-subtract-global-mean": "ivectors",
    "ivector-normalize-length": "ivectors",
    "ivector-compute-plda": "plda", "ivector-plda-scoring": "scoring",
    "ivector-compute-dot-products": "scoring", "compute-eer": "scoring",
    "logistic-regression-train": "lid", "logistic-regression-eval": "lid"}


def sre_cli_files(d: str, corpus: dict) -> dict:
    """`sre_corpus`'s waves as 8 kHz 16-bit wav files under d with
    Kaldi's data dirs: {set: wav.scp} for train (spk-uN), enroll (spk)
    and test (spk_t), train's utt2spk and spk2utt, test's utt2spk and
    the trials (every enrollment speaker against every test utterance,
    '<spk> <test-utt>'). -> the paths."""
    from kaldi_tpu_torch.io.wave import write_wave
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    sets = {"train": [(f"{s}-u{i}", w) for s, ws in corpus["train"].items()
                      for i, w in enumerate(ws)],
            "enroll": list(corpus["enroll"].items()),
            "test": list(corpus["test"].items())}
    for name, utts in sets.items():
        os.makedirs(P(name, "wav"), exist_ok=True)
        with open(P(name, "wav.scp"), "w") as f:
            for u, w in utts:
                write_wave(P(name, "wav", f"{u}.wav"), w, GMM_SR)
                f.write(f"{u} {P(name, 'wav', u + '.wav')}\n")
    spks = list(corpus["train"])
    with open(P("train", "utt2spk"), "w") as f:
        f.writelines(f"{u} {u.split('-')[0]}\n" for u, _w in sets["train"])
    with open(P("train", "spk2utt"), "w") as f:
        for s in spks:
            f.write(s + " " + " ".join(f"{s}-u{i}" for i in range(
                len(corpus["train"][s]))) + "\n")
    with open(P("test", "utt2spk"), "w") as f:
        f.writelines(f"{u} {u[:-2]}\n" for u, _w in sets["test"])
    with open(P("trials"), "w") as f:
        f.writelines(f"{e} {t}\n" for e in corpus["enroll"]
                     for t in corpus["test"])
    return {k: len(v) for k, v in sets.items()}


def phase_sre_cli(card: str) -> dict:
    """Phase 40: egs/sre10/v1's run.sh through the port's CLI files on
    phase 26's corpus (`sre_corpus(**SRE)`, synthesized again: 200
    speakers, 1200 training, 200 enrollment and 200 test utterances,
    40,000 trials), on the card:
    compute-mfcc-feats (SRE_CLI_MFCC) -> add-deltas (60 dims) ->
    compute-vad (on the cepstra) -> select-voiced-frames for each set;
    train-ubm --full (sid/train_diag_ubm.sh + train_full_ubm.sh fused, as
    JAX's CLI has them: 2048 gaussians); train-ivector-extractor
    (sid/train_ivector_extractor.sh fused: 600 dims); ivector-extract of
    the three sets, all at phase 26's depth (SRE_DEPTH); then
    local/plda_scoring.sh's scoring (ivector-mean of train; each set
    through ivector-normalize-length and ivector-subtract-global-mean as
    SRE_CLI_NORM says) -> ivector-compute-plda on train's spk2utt ->
    ivector-plda-scoring -> compute-eer, and cosine scoring by
    ivector-compute-dot-products -> compute-eer; logistic-regression-train
    over the training i-vectors as PLDA takes them (speakers as classes)
    -> -eval on the test ones. Cuts from egs/sre10 v1: speakers and hours
    (thousands of speakers there), sid/*.sh's sliding CMN before the VAD's
    selection (phase 26 has none), the MFCC's --high-freq and --snip-edges
    (not options of the CLI), and v2's DNN path (JAX's CLI has no fused
    command for it). Asserts the PLDA EER at or under SRE_CLI_EER_BAR and
    below the cosine EER, every score finite and no kernel launch. The
    extractor's file (f64, about 650 MB) and the arks live in a temporary
    directory under build/, removed at the end."""
    import shutil
    import torch
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    q.launches = tg.launches = 0
    torch.cuda.reset_peak_memory_stats()
    d = build_scratch()
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    kinds = dict.fromkeys(sorted(set(SRE_CLI_KIND.values())), 0.0)
    calls = dict.fromkeys(kinds, 0)
    stages, sizes, secs, eers = {}, {}, {}, {}
    scores: list = []

    def run(*argv):
        r = _cli_ok(argv[0], cli_call(list(argv)))
        kinds[SRE_CLI_KIND[argv[0]]] += r[2]
        calls[SRE_CLI_KIND[argv[0]]] += 1
        secs[argv[0]] = secs.get(argv[0], 0.0) + r[2]
        return r

    def eer(text: str, name: str) -> float:
        rows = [ln.split() for ln in text.splitlines()]
        scores.extend(float(sc) for _e, _t, sc in rows)
        with open(P(f"{name}.eer_in"), "w") as f:
            f.writelines(f"{sc} {'target' if e + '_t' == t else 'nontarget'}"
                         "\n" for e, t, sc in rows)
        line = run("compute-eer", P(f"{name}.eer_in"))[0]
        return float(line.split()[1].rstrip("%")) / 100.0

    def normalized(name: str) -> str:
        """The set's i-vectors as the scoring takes them -> their ark."""
        src = P(name, "iv.ark")
        for k, step in enumerate(SRE_CLI_NORM[name]):
            dst = P(name, f"iv.{k}.ark")
            if step == "c":
                run("ivector-subtract-global-mean", f"ark:{src}",
                    f"ark:{dst}", "--mean", P("mean.ark"))
            else:
                run("ivector-normalize-length", f"ark:{src}", f"ark:{dst}")
            src = dst
        return src

    try:
        t = time.perf_counter()
        corpus = sre_corpus(**SRE)
        stages["corpus"] = time.perf_counter() - t
        t = time.perf_counter()
        n_sets = sre_cli_files(d, corpus)
        stages["wav files"] = time.perf_counter() - t
        t = time.perf_counter()
        for name in n_sets:
            run("compute-mfcc-feats", P(name, "wav.scp"),
                f"ark:{P(name, 'mfcc.ark')}", *SRE_CLI_MFCC)
            run("add-deltas", f"ark:{P(name, 'mfcc.ark')}",
                f"ark:{P(name, 'feats.ark')}")
            run("compute-vad", f"ark:{P(name, 'mfcc.ark')}",
                f"ark:{P(name, 'vad.ark')}")
            run("select-voiced-frames", f"ark:{P(name, 'feats.ark')}",
                f"ark:{P(name, 'vad.ark')}", f"ark:{P(name, 'voiced.ark')}")
        stages["features"] = time.perf_counter() - t
        t = time.perf_counter()
        run("train-ubm", f"ark:{P('train', 'voiced.ark')}", P("ubm.npz"),
            "--num-gauss", str(SRE_WIDTH["num_gauss"]), "--num-iters",
            str(SRE_DEPTH["ubm_iters"]), "--full", "--full-iters",
            str(SRE_DEPTH["ubm_iters"]))
        stages["ubm"] = time.perf_counter() - t
        t = time.perf_counter()
        run("train-ivector-extractor", P("ubm.npz"),
            f"ark:{P('train', 'voiced.ark')}", P("extractor.npz"),
            "--ivector-dim", str(SRE_WIDTH["ivector_dim"]), "--num-iters",
            str(SRE_DEPTH["ivector_iters"]), "--num-gselect",
            SRE_CLI_GSELECT)
        stages["extractor"] = time.perf_counter() - t
        t = time.perf_counter()
        for name in n_sets:
            run("ivector-extract", P("extractor.npz"),
                f"ark:{P(name, 'voiced.ark')}", f"ark:{P(name, 'iv.ark')}",
                "--num-gselect", SRE_CLI_GSELECT)
        run("ivector-mean", f"ark:{P('train', 'iv.ark')}",
            f"ark:{P('mean.ark')}")
        stages["ivectors"] = time.perf_counter() - t
        t = time.perf_counter()
        arks = {name: normalized(name) for name in n_sets}
        run("ivector-compute-plda", P("train", "spk2utt"),
            f"ark:{arks['train']}", P("plda.npz"), "--num-iters",
            str(SRE_DEPTH["plda_iters"]))
        run("ivector-plda-scoring", P("plda.npz"), f"ark:{arks['enroll']}",
            f"ark:{arks['test']}", P("trials"), "--scores-out",
            P("plda.scores"))
        with open(P("plda.scores")) as f:
            eers["plda"] = eer(f.read(), "plda")
        eers["cosine"] = eer(run(
            "ivector-compute-dot-products", P("trials"),
            f"ark:cat {arks['enroll']} {arks['test']} |")[0], "cosine")
        stages["scoring"] = time.perf_counter() - t
        t = time.perf_counter()
        lr_loss = float(run(
            "logistic-regression-train", f"ark:{arks['train']}",
            P("train", "utt2spk"), P("lr.npz"))[3].split("final loss")[1])
        lr_acc = float(run(
            "logistic-regression-eval", P("lr.npz"), f"ark:{arks['test']}",
            f"ark:{P('lid.ark')}", "--utt2label", P("test", "utt2spk")
        )[3].split("accuracy")[1].split()[0])
        stages["lid"] = time.perf_counter() - t
        for n in ("ubm.npz", "extractor.npz", "plda.npz", "lr.npz"):
            sizes[n] = os.path.getsize(P(n))
        for name in n_sets:
            sizes[f"{name}/voiced.ark"] = os.path.getsize(
                P(name, "voiced.ark"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = time.perf_counter() - t0
    log(f"  sre10 v1 through {sum(calls.values())} CLI calls on {n_sets} "
        f"utterances ({len(scores) // 2} trials) at {SRE_DEPTH} in "
        f"{total:.3f} s; peak card memory {peak:.2f} GiB | card: {card}")
    log("  seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    log("  seconds by command kind (calls): " + ", ".join(
        f"{k} {v:.3f} ({calls[k]})" for k, v in kinds.items()))
    log("  seconds by command: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))
    log("  file sizes (bytes): " + ", ".join(
        f"{k} {v}" for k, v in sizes.items()))
    log(f"  EER: PLDA {eers['plda'] * 100:.2f}%, cosine "
        f"{eers['cosine'] * 100:.2f}%; logistic regression final loss "
        f"{lr_loss:.4f}, closed-set accuracy on the test i-vectors "
        f"{lr_acc * 100:.2f}%")
    checks = [(f"PLDA EER <= {SRE_CLI_EER_BAR:.2f}",
               eers["plda"] <= SRE_CLI_EER_BAR),
              ("PLDA EER < cosine EER", eers["plda"] < eers["cosine"]),
              ("every score finite", bool(np.isfinite(scores).all())),
              ("no kernel launch", not (tg.launches or q.launches))]
    log("  " + ", ".join(f"{c} {'ok' if ok else 'FAILS'}"
                         for c, ok in checks)
        + f"; launches: gather {tg.launches}, qaffine {q.launches}; phase 40 "
        f"took {total:.3f} s")
    failed = [c for c, ok in checks if not ok]
    if failed:
        raise AssertionError(f"phase 40: {failed} fail (EERs {eers})")
    return dict(eer=eers, launches={"gather": tg.launches,
                                    "qaffine": q.launches},
                seconds=total, stages=stages, lr_accuracy=lr_acc)


# ------------------------------------------- adaptation and SGMM2 (27-28)

LVTLN_WARPS = [round(0.88 + 0.02 * k, 2) for k in range(13)]
ADAPT_BASIS = dict(basis_size=100, eta=0.2)
# egs/rm/s5 sgmm2_4a: train_ubm.sh 400, phn_dim = D + 1, gselect 15
# (Sgmm2GselectConfig), train_sgmm2.sh 2500 7500 (3 substates per pdf);
# 8 of its 25 iterations, speaker subspace off (never estimated: `vMwSc`)
SGMM_WIDTH = dict(ubm_gauss=400, phn_dim=31, spk_dim=0, num_iters=8,
                  num_gselect=15)
SGMM_SUBSTATES_PER_PDF = 3
# SGMM2 bMMI iterations (SgmmMmiOpts' default 2 took 19.5 s on an NVIDIA
# H100 80GB HBM3 at 700 W; cut for the time limit)
SGMM_MMI_ITERS = 1
RAW_WITNESS = os.path.join(ROOT, "chiprun_out", "raw_fmllr_witness.pkl")


def _by_leaf(tree, per_gauss: dict) -> dict:
    """{gaussian: W} of a regression-tree estimate -> {leaf: W}."""
    return {int(leaf): per_gauss[int(np.flatnonzero(tree.gauss2leaf
                                                    == leaf)[0])]
            for leaf in tree.leaves}


def _lda_full(lang, tri, train, train_raw, lopts):
    """The square LDA (all 91 rows) from train_lda_mllt's statistics: tri's
    alignments' pdfs as classes over the spliced raw MFCC. -> (transform
    [91, 92], spliced [(T, 91)], pdfs [(T,)])."""
    from kaldi_tpu_torch.steps.lda_mllt import _align, _splice
    from kaldi_tpu_torch.transform.lda import LdaStats, estimate_lda
    align = _align(lang, tri, train, lopts.acoustic_scale)
    tid2pdf = tri.trans_model.id2pdf_array
    spliced = [_splice(f, lopts, "cuda").cpu().numpy()
               for _u, f, _w in train_raw]
    st = LdaStats(tri.am.num_pdfs, spliced[0].shape[1])
    pdfs = []
    for b, res in enumerate(align):
        T = min(len(res[0]), len(spliced[b]))
        pdfs.append(tid2pdf[res[0][:T]])
        spliced[b] = spliced[b][:T]
        st.accumulate(spliced[b], pdfs[-1])
    full, _ev = estimate_lda(st, spliced[0].shape[1])
    return np.asarray(full, np.float64), spliced, pdfs


def _rejected_variance(raw_feats: list, W, full, lda_dim: int, lopts) -> float:
    """Mean variance of the square LDA's rejected rows (unit within-class
    variance on the training data by construction) over a speaker's raw
    frames with the raw transform W applied."""
    from kaldi_tpu_torch.steps.lda_mllt import _splice
    from kaldi_tpu_torch.transform.fmllr import apply_affine_transform
    rows = full[lda_dim:]
    ys = []
    for f in raw_feats:
        x = apply_affine_transform(f, W, "cuda")
        sp = _splice(x.cpu().numpy(), lopts, "cuda").cpu().numpy()
        ys.append(sp.astype(np.float64) @ rows[:, :-1].T + rows[:, -1])
    return float(np.concatenate(ys).var(axis=0).mean())


SGMM_WITNESS = os.path.join(ROOT, "chiprun_out", "sgmm_witness.pkl")


def save_sgmm_witness(snaps: list, likes: list, gmm, utts, num_gselect: int,
                      card: str):
    """The SGMM2 iteration whose update lowered the loglike per frame most
    (or the last), for tests/test_torch_sgmm_witness.py: its model and
    statistics before the update (host arrays), its flags, the loglikes,
    and the aligned training frames that replay the loglike after the
    update."""
    import pickle
    from kaldi_tpu_torch.steps.tdnn import align_with_gmm
    falls = [likes[k + 1] - likes[k] for k in range(len(likes) - 1)]
    k = int(np.argmin(falls)) if falls else len(snaps) - 1
    it, flags, model, accs = snaps[k]
    aligned = align_with_gmm(gmm, utts)
    a = lambda t: t.cpu().numpy()  # noqa: E731
    os.makedirs(os.path.dirname(SGMM_WITNESS), exist_ok=True)
    with open(SGMM_WITNESS, "wb") as f:
        pickle.dump(dict(
            iter=it, flags=flags, likes=likes, num_gselect=num_gselect,
            model=dict(Sigma_inv=a(model.Sigma_inv), M=a(model.M),
                       w=a(model.w), V=a(model.V), c=a(model.c),
                       offsets=model.offsets),
            accs=dict(gamma=a(accs.gamma), y=a(accs.y), Y=a(accs.Y),
                      Q=a(accs.Q), S_centered=a(accs.S_centered),
                      tot_like=accs.tot_like, tot_frames=accs.tot_frames),
            x=np.concatenate([f for f, _p in aligned]).astype(np.float32),
            pdfs=np.concatenate([p for _f, p in aligned]), card=card), f)
    log(f"  (d) saved iteration {it} ({flags}: loglike/frame "
        f"{likes[it]:.4f} -> {likes[min(it + 1, len(likes) - 1)]:.4f}) to "
        f"{os.path.relpath(SGMM_WITNESS, ROOT)}")


def phase_adapt_sgmm_full(card: str, ladder: dict) -> dict:
    """Phase 28 on phase 20's ladder models: (a) adaptation of the LDA+MLLT
    model per test speaker (raw fMLLR with the rejected-dimension
    diagnostic and the witness's inputs saved, basis fMLLR per test
    utterance from a basis of the 200 training utterances, regression-tree
    fMLLR and MLLR, global fMLLR); (b) LVTLN on the tri model, one class per
    warp in 0.88-1.12; (c) HLDA on the 91-dim spliced MFCC; (d) SGMM2 at
    egs/rm's sgmm2_4a widths from the LDA+MLLT model, bMMI over the
    ladder's unigram HCLG and SGMM fMLLR per test speaker. Every decode goes
    through make_hclg_flat + CsrBeamDecoder; qaffine must not launch."""
    import pickle
    import torch
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.sgmm.fmllr import (FmllrSgmm2Accs, apply_fmllr,
                                            estimate_sgmm2_fmllr)
    from kaldi_tpu_torch.steps import lda_mllt
    from kaldi_tpu_torch.steps.sgmm_steps import (SgmmAm, SgmmMmiOpts,
                                                  SgmmTrainOpts,
                                                  train_sgmm2_bmmi,
                                                  train_sgmm2_system)
    from kaldi_tpu_torch.transform import basis_fmllr as bf
    from kaldi_tpu_torch.transform import regtree as rt
    from kaldi_tpu_torch.transform.fmllr import (FmllrStats,
                                                 apply_affine_transform,
                                                 estimate_fmllr)
    from kaldi_tpu_torch.transform.fmllr_raw import (FmllrRawAccs,
                                                     estimate_fmllr_raw,
                                                     fmllr_raw_auxf)
    from kaldi_tpu_torch.transform.hlda import HldaStats, estimate_hlda
    from kaldi_tpu_torch.transform.lvtln import LinearVtln

    t0 = time.perf_counter()
    q.launches = tg.launches = 0
    m = ladder["models"]
    lang, arpa, refs, dopts = m["lang"], m["arpa"], m["refs"], m["dopts"]
    tri, lda = m["tri"], m["lda"]
    lopts = lda_mllt.LdaMlltTrainOpts(**LADDER_LDA)
    corpus = m["corpus"]
    utts = [u for u, _w, _ws, _s in corpus["test"]]
    spk = [s for _u, _w, _ws, s in corpus["test"]]
    speakers = sorted(set(spk))
    out, shapes = {}, set()

    def decode(dec, ll, nf):
        shapes.update(csr_gather_shapes(dec, ll.shape[0], ll.shape[2]))
        return dec.decode(ll, nf)

    def words(res):
        return [[lang.words.sym(x) for x in r[0]] if r else [] for r in res]

    def wer_of(dec, model, fl):
        fb, nf = pad_batch(fl)
        return wer(refs, words(decode(dec, model.am.loglikes(fb), nf)))

    def first_pass(dec, model, fl):
        fb, nf = pad_batch(fl)
        res = decode(dec, model.am.loglikes(fb), nf)
        tid2pdf = model.trans_model.id2pdf_array
        return wer(refs, words(res)), [
            tid2pdf[np.asarray(r[1][:int(nf[b])])] for b, r in enumerate(res)]

    dec_l, _s = ladder_decoder(lda.model, arpa, dopts, "cuda")
    test_l = [f for _u, f, _w in m["test_l"]]
    test_raw = [f for _u, f, _w in m["test_raw"]]
    w_si, pdfs = first_pass(dec_l, lda.model, test_l)
    log(f"  (a) LDA+MLLT SI decode (first pass) WER {w_si:.2f} | card: {card}")

    def per_speaker(fn):
        return {s: fn([b for b in range(len(utts)) if spk[b] == s])
                for s in speakers}

    # (a) global fMLLR per speaker, for comparison
    t = time.perf_counter()

    def global_w(bs):
        st = FmllrStats(lda.model.am.dim)
        for b in bs:
            st.accumulate_from_alignment(lda.model.am, test_l[b], pdfs[b])
        return estimate_fmllr(st, min_count=100.0)[0]

    Wg = per_speaker(global_w)
    fl = [apply_affine_transform(test_l[b], Wg[spk[b]], "cuda").cpu().numpy()
          for b in range(len(utts))]
    out["fmllr"] = dict(wer=wer_of(dec_l, lda.model, fl),
                        secs=time.perf_counter() - t)
    # (a) raw fMLLR per speaker (the refused PR's configuration)
    t = time.perf_counter()
    full, spliced_tr, pdfs_tr = _lda_full(lang, tri, m["train"],
                                          m["train_raw"], lopts)
    t_lda = time.perf_counter() - t
    t = time.perf_counter()
    raw, witness = {}, {}
    for s in speakers:
        bs = [b for b in range(len(utts)) if spk[b] == s]
        accs = FmllrRawAccs(test_raw[0].shape[1], lopts.splice_left,
                            lopts.splice_right, "cuda")
        for b in bs:
            accs.accumulate_from_alignment(lda.model.am, test_raw[b],
                                           lda.transform, pdfs[b])
        hist: list = []
        W, gain = estimate_fmllr_raw(accs, lda.transform, history=hist)
        X, mu, iv, gam = accs.stacked()
        A = torch.as_tensor(W, device="cuda")
        Tm = torch.as_tensor(lda.transform, dtype=torch.float32,
                             device="cuda")
        d, n = accs.d, accs.L + accs.R + 1
        ident = torch.cat([torch.eye(d, device="cuda"),
                           torch.zeros((d, 1), device="cuda")], 1)
        q0 = float(fmllr_raw_auxf(ident, X, Tm, mu, iv, gam, 0.0, d, n))
        q1 = float(fmllr_raw_auxf(A, X, Tm, mu, iv, gam, 0.0, d, n))
        logdet_share = accs.beta() * float(torch.linalg.slogdet(
            A[:, :d].double())[1]) / max(gain * accs.beta(), 1e-30)
        raw[s] = dict(W=W, gain=gain, frames=accs.num_frames,
                      beta=accs.beta(), quad_gain=(q1 - q0) / accs.beta(),
                      logdet_share=logdet_share,
                      rej_before=_rejected_variance(
                          [test_raw[b] for b in bs], np.concatenate(
                              [np.eye(d), np.zeros((d, 1))], 1), full,
                          lda.model.am.dim, lopts),
                      rej_after=_rejected_variance(
                          [test_raw[b] for b in bs], W, full,
                          lda.model.am.dim, lopts))
        witness[s] = dict(X=X.cpu().numpy(), gam=gam.cpu().numpy(),
                          pdfs=np.concatenate([pdfs[b] for b in bs]),
                          W=W, gain=gain, history=hist,
                          rejected=(raw[s]["rej_before"],
                                    raw[s]["rej_after"]))
    fl = [lda.transform_feats(apply_affine_transform(
        test_raw[b], raw[spk[b]]["W"], "cuda").cpu().numpy(), lopts)
          for b in range(len(utts))]
    out["raw_fmllr"] = dict(wer=wer_of(dec_l, lda.model, fl),
                            secs=time.perf_counter() - t)
    for s in speakers:
        r = raw[s]
        log(f"  (a) raw fMLLR {s}: {r['frames']} frames, gain "
            f"{r['gain']:.4f} nats/frame (quadratic term {r['quad_gain']:.4f},"
            f" beta log|det A| {r['logdet_share']:.3f} of the gain); "
            f"rejected-row variance {r['rej_before']:.4f} -> "
            f"{r['rej_after']:.4f} (1 on training data by construction)")
    # the witness's inputs: replayed through JAX's estimate_fmllr_raw on
    # the CPU by tests/test_torch_raw_witness.py
    os.makedirs(os.path.dirname(RAW_WITNESS), exist_ok=True)
    lm = lda.model
    am_cpu = type(lm.am)(lm.am.pdfs, "cpu")
    with open(RAW_WITNESS, "wb") as f:
        pickle.dump(dict(
            speakers=witness, transform=lda.transform, full_lda=full,
            splice=(lopts.splice_left, lopts.splice_right),
            model=dict(pdfs=[(g.weights, g.means, g.vars) for g in am_cpu.pdfs],
                       trans_model=lm.trans_model, ctx_dep=lm.ctx_dep),
            lexicon=corpus["lex_text"], arpa=arpa, refs=refs, utts=utts,
            spk=spk, test_raw=test_raw, dopts=dataclasses.asdict(dopts),
            wer=dict(si=w_si, raw=out["raw_fmllr"]["wer"]), card=card), f)
    # (a) basis fMLLR: the basis from the 200 training utterances'
    # statistics (one gradient per utterance), transforms per test utterance
    t = time.perf_counter()
    ali_tr = lda_mllt._align(lang, lda.model, m["train_l"], 0.1)
    accus = bf.BasisFmllrAccus(lda.model.am.dim, "cuda")
    tid2pdf = lda.model.trans_model.id2pdf_array
    for (_u, f, _w), res in zip(m["train_l"], ali_tr):
        st = FmllrStats(lda.model.am.dim)
        T = min(len(res[0]), len(f))
        st.accumulate_from_alignment(lda.model.am, f[:T], tid2pdf[res[0][:T]])
        accus.accumulate_from_speaker(st)
    basis = bf.estimate_fmllr_basis(accus, ADAPT_BASIS["basis_size"])
    t_basis = time.perf_counter() - t
    fl, n_used = [], []
    for b in range(len(utts)):
        st = FmllrStats(lda.model.am.dim)
        st.accumulate_from_alignment(lda.model.am, test_l[b], pdfs[b])
        W, n, _g = bf.compute_basis_fmllr_transform(st, basis,
                                                    eta=ADAPT_BASIS["eta"])
        n_used.append(n)
        fl.append(apply_affine_transform(test_l[b], W.cpu().numpy(),
                                         "cuda").cpu().numpy())
    out["basis_fmllr"] = dict(wer=wer_of(dec_l, lda.model, fl),
                              secs=time.perf_counter() - t,
                              basis_secs=t_basis,
                              coeffs=float(np.mean(n_used)))
    # (a) regression-tree fMLLR and MLLR per speaker, at JAX's defaults
    t = time.perf_counter()
    tree = rt.RegressionTree(lda.model.am, device="cuda")
    post = [[[(int(p), 1.0)] for p in pdfs[b]] for b in range(len(utts))]
    ll_rt, ll_mllr = [None] * len(utts), [None] * len(utts)
    for s in speakers:
        bs = [b for b in range(len(utts)) if spk[b] == s]
        acc = rt.RegtreeStats(tree, lda.model.am.dim)
        macc = rt.RegtreeMllrStats(tree, lda.model.am.dim)
        for b in bs:
            acc.accumulate(lda.model.am, test_l[b], post[b])
            macc.accumulate(lda.model.am, test_l[b], post[b])
        by_leaf = _by_leaf(tree, rt.estimate_regtree_fmllr(acc))
        am_m = rt.apply_regtree_mllr(lda.model.am, tree, _by_leaf(
            tree, rt.estimate_regtree_mllr(macc)))
        for b in bs:
            ll_rt[b] = rt.regtree_fmllr_loglikes(lda.model.am, tree, by_leaf,
                                                 test_l[b]).float()
            ll_mllr[b] = am_m.loglikes(test_l[b])
    for name, lls in (("regtree_fmllr", ll_rt), ("regtree_mllr", ll_mllr)):
        fb, nf = pad_batch([np.zeros((len(f), 1)) for f in test_l])
        ll = torch.zeros((len(lls), fb.shape[1], lls[0].shape[1]),
                         device="cuda")
        for b, x in enumerate(lls):
            ll[b, :len(x)] = x
        out[name] = dict(wer=wer(refs, words(decode(dec_l, ll, nf))),
                         secs=time.perf_counter() - t)
    out["regtree_leaves"] = len(tree.leaves)
    log("  (a) adaptation of the LDA+MLLT model (SI " + f"{w_si:.2f}): "
        + ", ".join(f"{k} WER {out[k]['wer']:.2f} in {out[k]['secs']:.3f} s"
                    for k in ("fmllr", "raw_fmllr", "basis_fmllr",
                              "regtree_fmllr", "regtree_mllr"))
        + f"; square LDA {t_lda:.3f} s; basis of "
        f"{ADAPT_BASIS['basis_size']} from {len(ali_tr)} utterances in "
        f"{t_basis:.3f} s, {out['basis_fmllr']['coeffs']:.1f} coefficients "
        f"per test utterance; regression tree of {len(tree.leaves)} leaves "
        f"| card: {card}")

    # (b) LVTLN on the tri model (MFCC + deltas), one class per warp
    t = time.perf_counter()
    tr_w = [w for _u, w, _ws, _s in corpus["train"]]
    X = np.concatenate([f for _u, f, _w in m["train"]])
    lv = LinearVtln(X.shape[1], LVTLN_WARPS, "cuda")
    for c, wp in enumerate(LVTLN_WARPS):
        if wp != 1.0:
            lv.train_class(c, X, np.concatenate(
                ladder_feats(tr_w, True, "cuda", vtln_warp=wp)))
    t_train = time.perf_counter() - t
    del X
    dec_t, _s = ladder_decoder(tri, arpa, dopts, "cuda")
    test_d = [f for _u, f, _w in m["test"]]
    w_tri, pdfs_t = first_pass(dec_t, tri, test_d)
    sel, lv_stats = {}, {}
    for s in speakers:
        st = lv_stats[s] = FmllrStats(tri.am.dim)
        for b in range(len(utts)):
            if spk[b] == s:
                st.accumulate_from_alignment(tri.am, test_d[b], pdfs_t[b])
        c, W, aux = lv.select_class(st)
        sel[s] = (LVTLN_WARPS[c], W, (np.asarray(aux) - aux[
            lv.default_class]) / st.beta)
    save_witness(LVTLN_WITNESS, lvtln_witness_data(lv, lv_stats))
    fl = [apply_affine_transform(test_d[b], sel[spk[b]][1], "cuda").cpu()
          .numpy() for b in range(len(utts))]
    out["lvtln"] = dict(wer=wer_of(dec_t, tri, fl), si_wer=w_tri,
                        secs=time.perf_counter() - t, train_secs=t_train,
                        selected={s: sel[s][0] for s in speakers},
                        true={s: corpus["warps"][s] for s in speakers})
    log(f"  (b) LVTLN on tri: {len(LVTLN_WARPS)} classes trained in "
        f"{t_train:.3f} s; selected warp vs the speaker's true warp: "
        + ", ".join(f"{s} {sel[s][0]:.2f} vs {corpus['warps'][s]:.4f}"
                    for s in speakers)
        + "; each class's auxiliary over the identity's, per frame: "
        + "; ".join(f"{s} " + " ".join(f"{a:+.3f}" for a in sel[s][2])
                    for s in speakers)
        + f"; WER {w_tri:.2f} without, {out['lvtln']['wer']:.2f} with the "
        f"selected transforms ({out['lvtln']['secs']:.3f} s) | card: {card}")

    # (c) HLDA on the 91-dim spliced MFCC, tri's pdfs as classes
    t = time.perf_counter()
    hs = HldaStats(spliced_tr[0].shape[1], "cuda")
    hs.accumulate(np.concatenate(spliced_tr), np.concatenate(pdfs_tr),
                  tri.am.num_pdfs)
    A_h, impr = estimate_hlda(hs, lda.model.am.dim)
    out["hlda"] = dict(gain=impr, secs=time.perf_counter() - t,
                       frames=int(hs.beta), shape=list(A_h.shape))
    log(f"  (c) HLDA {spliced_tr[0].shape[1]} -> {A_h.shape[0]} dims over "
        f"{int(hs.beta)} frames and {tri.am.num_pdfs} classes: gain "
        f"{impr:.4f} per frame in {out['hlda']['secs']:.3f} s | card: {card}")

    # (d) SGMM2 at egs/rm's sgmm2_4a widths from the LDA+MLLT model
    torch.cuda.reset_peak_memory_stats()
    P = lda.model.am.num_pdfs
    sopts = SgmmTrainOpts(**SGMM_WIDTH,
                          total_substates=SGMM_SUBSTATES_PER_PDF * P)
    its: list = []
    stages: dict = {}
    snaps: list = []

    def snapshot(it, flags, model, accs):
        snaps.append((it, flags, model.to("cpu"), _accs_to(accs, "cpu")))

    t = time.perf_counter()
    sam, likes = train_sgmm2_system(lda.model, m["train_l"], sopts,
                                    iter_stats=its, stage_secs=stages,
                                    snapshot=snapshot)
    t_ml = time.perf_counter() - t
    save_sgmm_witness(snaps, likes, lda.model, m["train_l"],
                      sopts.num_gselect, card)
    peak_ml = torch.cuda.max_memory_allocated() / 2 ** 30
    sg = sam.sgmm
    t = time.perf_counter()
    fb, nf = pad_batch(test_l)
    res = decode(dec_l, sam.loglikes(fb), nf)
    w_ml = wer(refs, words(res))
    t_dec = time.perf_counter() - t
    tid2pdf = lda.model.trans_model.id2pdf_array
    pdfs_s = [tid2pdf[np.asarray(r[1][:int(nf[b])])]
              for b, r in enumerate(res)]
    log(f"  (d) SGMM2 ML: I {sg.num_gauss}, S {sg.phn_dim}, gselect "
        f"{sam.num_gselect}, {int(sg.offsets[-1])} substates over {P} "
        f"states, {sum(len(f) for _u, f, _w in m['train_l'])} frames; "
        f"stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; per iteration (flags, loglike/frame, accumulate / update s): "
        + ", ".join(f"{s['flags']} {s['loglike']:.4f} "
                    f"{s['accumulate']:.3f}/{s['update']:.3f}" for s in its)
        + f"; peak {peak_ml:.2f} GiB; test decode {t_dec:.3f} s, WER "
        f"{w_ml:.2f} (LDA+MLLT GMM {w_si:.2f}) | card: {card}")
    g = arpa_to_g(ArpaLm.parse(arpa), lang.words)
    den = make_hclg(lang, g, lda.model.trans_model, lda.model.ctx_dep,
                    self_loop_scale=0.1)
    sam_b = SgmmAm(sg.copy(), sam.num_gselect)
    mmi_opts = SgmmMmiOpts(num_iters=SGMM_MMI_ITERS)
    mits: list = []
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sam_b, objs = train_sgmm2_bmmi(lda.model, sam_b, den, m["train_l"],
                                   mmi_opts, iter_stats=mits)
    t_mmi = time.perf_counter() - t
    peak_mmi = torch.cuda.max_memory_allocated() / 2 ** 30
    fb, nf = pad_batch(test_l)
    w_mmi = wer(refs, words(decode(dec_l, sam_b.loglikes(fb), nf)))
    log(f"  (d) SGMM2 bMMI {dataclasses.asdict(mmi_opts)}: objective "
        + ", ".join(f"{o:.5f}" for o in objs) + f" in {t_mmi:.3f} s ("
        + "; ".join(", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                              f"{k} {v}" for k, v in st.items())
                    for st in mits)
        + f"); peak {peak_mmi:.2f} GiB; WER {w_mmi:.2f} | card: {card}")
    t = time.perf_counter()
    Ws = {}
    for s in speakers:
        bs = [b for b in range(len(utts)) if spk[b] == s]
        fa = FmllrSgmm2Accs(sg)
        fa.accumulate(sg, np.concatenate([test_l[b] for b in bs]),
                      (np.arange(sum(len(test_l[b]) for b in bs)),
                       np.concatenate([pdfs_s[b] for b in bs]),
                       np.ones(sum(len(test_l[b]) for b in bs))),
                      sam.num_gselect)
        Ws[s] = estimate_sgmm2_fmllr(fa, sg)
    fl = [apply_fmllr(Ws[spk[b]][0], test_l[b]).float().cpu().numpy()
          for b in range(len(utts))]
    fb, nf = pad_batch(fl)
    w_f = wer(refs, words(decode(dec_l, sam.loglikes(fb), nf)))
    t_f = time.perf_counter() - t
    out["sgmm"] = dict(wer=w_ml, bmmi_wer=w_mmi, fmllr_wer=w_f, likes=likes,
                       mmi_objs=objs, secs=t_ml, bmmi_secs=t_mmi,
                       fmllr_secs=t_f, peak_gib=peak_ml,
                       bmmi_peak_gib=peak_mmi, iters=its, stages=stages,
                       substates=int(sg.offsets[-1]))
    log(f"  (d) SGMM2 fMLLR per test speaker (gain per frame "
        + ", ".join(f"{s} {Ws[s][1]:.4f}" for s in speakers)
        + f"): WER {w_f:.2f} in {t_f:.3f} s; SGMM ML {w_ml:.2f}, bMMI "
        f"{w_mmi:.2f}, ML + fMLLR {w_f:.2f} vs the LDA+MLLT GMM {w_si:.2f} "
        f"(PARITY.md:36's SGMM <= GMM + 5.0 and < 20.0 is reported here, "
        f"held on yesno in phase 27) | card: {card}")
    check = _Limits()
    check.require("SGMM loglike/frame finite", all(np.isfinite(likes)))
    check.require("bMMI objectives finite",
                  all(np.isfinite(o) for o in objs))
    for k in ("fmllr", "raw_fmllr", "basis_fmllr", "regtree_fmllr",
              "regtree_mllr", "lvtln"):
        check.require(f"{k} WER finite", np.isfinite(out[k]["wer"]))
    check.require("HLDA gain >= 0", out["hlda"]["gain"] >= -1e-9)
    check.require(f"qaffine launched {q.launches} times", q.launches == 0)
    check.done("phase 28")
    launches = tg.launches
    log(f"  launches on phase 28: gather {launches} (its decodes), qaffine "
        f"{q.launches}; phase 28 took {time.perf_counter() - t0:.3f} s")
    g_times = gather_at_shapes(tg, sorted(shapes), "phase 28's", 28)
    return dict(out, launches=launches, gather_times=g_times)


SGMM_SMALL = dict(num_gselect=3, substates=6)
SGMM_YESNO = {13: dict(train=14, test=6, sgmm_iters=6, bmmi=False),
              21: dict(train=12, test=6, sgmm_iters=4, bmmi=True)}
SGMM_YESNO_MONO = dict(num_iters=8, totgauss=30, max_iter_inc=6,
                       realign_iters=tuple(range(1, 8)))
RAW_STEP_LIMIT = 1e-5          # one f32 Adam step, relative to max |W|
# Whole runs are held by their objective, not their W: near the optimum
# Adam's m / sqrt(v) and a backtracking line search's `val > cur` branch
# follow rounding noise, so equal objectives come with W apart.
RAW_RUN_LIMIT = 1e-3           # a whole f32 Adam run (raw fMLLR)
LINE_SEARCH_LIMIT = 1e-9       # a whole f64 line search (basis, SGMM fMLLR)


def sgmm_small_setup(device, split: bool = True) -> dict:
    """tests/test_sgmm.py's `sgmm_setup` built by the port: three classes
    from RandomState(0) (150 frames of 4 dims each), a 4-gaussian UBM by
    host EM, `AmSgmm2(phn_dim=5, spk_dim=2, seed=1)` on `device`, split to
    6 substates unless split is False; a speaker shifted by RandomState(9)'s offset. -> {"model",
    "feats", "post", "spk_feats", "spk_post"}."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.estimation import (AccumDiagGmm,
                                                mle_diag_gmm_update)
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.sgmm import AmSgmm2
    rng = np.random.RandomState(0)
    mu = rng.randn(3, 4) * 3.0
    feats = np.concatenate([mu[j] + rng.randn(150, 4) for j in range(3)])
    post = [[(j, 1.0)] for j in range(3) for _ in range(150)]
    ubm = DiagGmm.from_stats(feats.mean(0), feats.var(0)).split(4)
    for _ in range(5):
        acc = AccumDiagGmm(ubm.num_gauss, ubm.dim)
        acc.accumulate(ubm, feats.astype(np.float32))
        ubm = mle_diag_gmm_update(ubm, acc)
    fubm = FullGmm.from_diag(ubm.weights, ubm.means, ubm.vars)
    model = AmSgmm2(fubm, num_states=3, phn_dim=5, spk_dim=2, seed=1,
                    device=device)
    if split:
        model.split_substates(SGMM_SMALL["substates"])
    offset = np.random.RandomState(9).randn(4) * 0.8
    return dict(model=model, feats=feats, post=post,
                spk_feats=feats[:100] + offset, spk_post=post[:100])


def _sgmm_dense_ll(model, x, entries, K, spk):
    """Per entry the component loglikes [E, Mmax, I] (-inf off the
    entry's state's substates and the frame's gselect), f64 host, and the
    gselect sets [T, K]."""
    from kaldi_tpu_torch.sgmm.estimate import by_state, state_entries
    t, j, _w = state_entries(entries, model.device)
    xd = model._x(x)
    gsel = model.gselect(xd, K)
    nrm = model.normalizers()
    Mmax = int(model.num_substates.max())
    out = np.full((len(t), Mmax, model.num_gauss), -np.inf)
    for s, idx in by_state(j):
        z, q = model.frame_terms(xd[t[idx]], gsel[t[idx]], spk)
        ll = model.state_component_loglikes(s, z, q, gsel[t[idx]], nrm)
        ii = idx.cpu().numpy()
        g = gsel[t[idx]].cpu().numpy()
        llh = ll.cpu().numpy()
        for k in range(g.shape[1]):
            out[ii[:, None], np.arange(llh.shape[1])[None, :], g[:, k:k + 1]] \
                = llh[:, :, k]
    return out, np.sort(gsel.cpu().numpy(), axis=1)


def _sgmm_terms(model, x, entries, weights, spk):
    """The SGMM statistics' terms with absolute values, each (entry,
    substate, gaussian) weighted by weights [E, Mmax, I]: -> dict of
    gamma [Mtot, I], y [Mtot, S], Y [I, D, S], Q [I, S, S], S [I, D, D]
    (host f64): sum_e w (1, |SinvM|' |x - o|, |x - o| |v|', |v| |v|',
    (|x| + |mu|)(|x| + |mu|)')."""
    from kaldi_tpu_torch.sgmm.estimate import state_entries
    t, j, _w = (a.cpu().numpy() for a in state_entries(entries, "cpu"))
    I, D, S = model.M.shape
    V = model.V.cpu().numpy()
    M = model.M.cpu().numpy()
    SinvM = np.abs(model.SinvM.cpu().numpy())
    off = model.spk_offsets(spk)
    off = np.zeros((I, D)) if off is None else off.cpu().numpy()
    x = np.asarray(x, np.float64)
    Mtot = len(V)
    o = model.offsets
    out = dict(gamma=np.zeros((Mtot, I)), y=np.zeros((Mtot, S)),
               Y=np.zeros((I, D, S)), Q=np.zeros((I, S, S)),
               S=np.zeros((I, D, D)))
    for e in range(len(t)):
        a, b = o[j[e]], o[j[e] + 1]
        w = weights[e, :b - a]                                  # [M, I]
        xo = np.abs(x[t[e]][None] - off)                        # [I, D]
        v = np.abs(V[a:b])
        mu = np.abs(np.einsum("ids,ms->mid", M, V[a:b]) + off[None])
        out["gamma"][a:b] += w
        out["y"][a:b] += np.einsum("mi,id,ids->ms", w, xo, SinvM)
        out["Y"] += np.einsum("mi,id,ms->ids", w, xo, v)
        out["Q"] += np.einsum("mi,ms,mt->ist", w, v, v)
        xm = np.abs(x[t[e]])[None, None] + mu
        out["S"] += np.einsum("mi,mid,mie->ide", w, xm, xm)
    return out


def sgmm_stats_card_vs_cpu(model, x, entries, K: int, spk=None,
                           card: str = "cuda") -> dict:
    """`Sgmm2Accs` of the same entries with `model` (on the CPU) and its
    copy on `card`, each statistic held to the bound the two sides'
    component loglikes set: the exact softmax response to their measured
    difference (`softmax_shift_bound`, f64 rounding), times each term's
    magnitude, plus each side's f64 GEMM rounding 2 gamma_n of the terms
    (n the frames plus D^2). A frame whose gselect sets differ may move
    entirely (counted; it must lie within twice the score difference of
    the k-th / (k+1)-th gap). -> {stat: ratio to its bound, "flips",
    "unjustified", "ll" (the loglikes' largest difference over the terms'
    scale), "accs": the CPU's accumulators}."""
    from kaldi_tpu_torch.sgmm import Sgmm2Accs
    from kaldi_tpu_torch.sgmm.estimate import state_entries
    side = {"cpu": model, "card": model.to(card)}
    spk_on = {d: None if spk is None else type(spk)(spk.v.to(m.device))
              for d, m in side.items()}
    accs = {}
    for d, m in side.items():
        accs[d] = Sgmm2Accs(m)
        accs[d].accumulate(m, x, entries, K, spk_on[d])
    ll, sets = {}, {}
    for d, m in side.items():
        ll[d], sets[d] = _sgmm_dense_ll(m, x, entries, K, spk_on[d])
    t, _j, w = (a.cpu().numpy() for a in state_entries(entries, "cpu"))
    E = len(t)
    a, b = ll["cpu"].reshape(E, -1), ll["card"].reshape(E, -1)
    mask = np.isfinite(a) & np.isfinite(b)
    pa = np.exp(np.where(mask, a - a.max(1, keepdims=True), -np.inf))
    pa /= pa.sum(1, keepdims=True)
    pb = np.exp(np.where(np.isfinite(b), b - b.max(1, keepdims=True),
                         -np.inf))
    pb /= pb.sum(1, keepdims=True)
    a0, b0 = np.where(mask, a, 0.0), np.where(mask, b, 0.0)
    bound, _spr = softmax_shift_bound(a0, b0, pa, mask, eps=F64_EPS)
    flip = np.any(sets["cpu"] != sets["card"], axis=1)[t]
    scores = {d: m.gselect_scores(m._x(x)).cpu().numpy()
              for d, m in side.items()}
    srt = -np.sort(-scores["cpu"], axis=1)
    gap = srt[:, K - 1] - srt[:, K] if K < srt.shape[1] else \
        np.full(len(srt), np.inf)
    dsc = np.abs(scores["card"] - scores["cpu"]).max(axis=1)
    unjust = int(np.sum(np.any(sets["cpu"] != sets["card"], axis=1)
                        & (gap > 2.0 * dsc)))
    bound = np.where(flip[:, None], np.maximum(pa, pb), bound)
    shape = ll["cpu"].shape
    wb = (bound * w[:, None]).reshape(shape)
    wp = (pa * w[:, None]).reshape(shape)
    tb = _sgmm_terms(model, x, entries, wb, spk)
    tp = _sgmm_terms(model, x, entries, wp, spk)
    r = 2.0 * _gamma_n(E + model.dim ** 2, F64_EPS)
    cpu, crd = accs["cpu"], accs["card"]
    errs = {"flips": int(flip.sum()), "unjustified": unjust}
    for name, key in (("gamma", "gamma"), ("y", "y"), ("Y", "Y"), ("Q", "Q"),
                      ("S_centered", "S")):
        got = getattr(crd, name).cpu().numpy()
        want = getattr(cpu, name).cpu().numpy()
        errs[name] = _worst(got, want, tb[key] + r * tp[key])
    d = np.abs(b0 - a0).max(1)
    lse = np.abs(np.log(np.where(mask, np.exp(a - a.max(1, keepdims=True)),
                                 0.0).sum(1)) + a.max(1))
    errs["tot_like"] = abs(crd.tot_like - cpu.tot_like) / float(
        (w * (d + r * lse)).sum() + 1e-300)
    fin = np.isfinite(a)
    errs["ll"] = float(np.abs(b0 - a0).max()
                       / max(np.abs(np.where(fin, a, 0.0)).max(), 1e-300))
    errs["accs"] = cpu
    return errs


def sgmm_update_card_vs_cpu(model, accs, flags: str,
                            card: str = "cuda") -> dict:
    """`update_sgmm2` with each flag from the same statistics (the CPU's,
    copied to `card`) on both sides, each held by its backward error:
    v's solves (lhs v = rhs) and M's (M (Q + 1e-4 I) = Y) to
    `backward_bound`; Sigma's inverse of the floored scatter to
    SIGMA_C D eps64; the explicit w and c steps to 2 gamma_n of their
    terms. -> {flag: ratio to its bound}."""
    import torch
    from kaldi_tpu_torch.sgmm.estimate import update_sgmm2, v_system
    I, D, S = model.M.shape
    out = {}
    acc_card = _accs_to(accs, card)
    for f in flags:
        cpu, crd = model.copy(), model.to(card)
        update_sgmm2(cpu, accs, f)
        update_sgmm2(crd, acc_card, f)
        if f == "v":
            lhs, rhs, live = (a.cpu().numpy() for a in v_system(model, accs))
            worst = 0.0
            for side in (cpu, crd):
                v = side.V.cpu().numpy()[live]
                be = backward_error(np.transpose(lhs[live], (0, 2, 1)),
                                    v[:, None, :], rhs[live][:, None, :])
                worst = max(worst, float(be.max(initial=0.0)))
            out["v"] = worst / backward_bound(S, 1)
        elif f == "M":
            live = accs.gamma.sum(0).cpu().numpy() >= 1.0
            A = (accs.Q + 1e-4 * torch.eye(S, dtype=torch.float64)).numpy()
            B = accs.Y.cpu().numpy()
            worst = max(float(backward_error(
                A[live], side.M.cpu().numpy()[live], B[live]).max(initial=0))
                for side in (cpu, crd))
            out["M"] = worst / backward_bound(S, D)
        elif f == "S":
            g = accs.gamma.sum(0).cpu().numpy()
            live = g >= D
            Si = accs.S_centered.cpu().numpy()[live] / g[live][:, None, None]
            Si = 0.5 * (Si + np.transpose(Si, (0, 2, 1)))
            ev, U = np.linalg.eigh(Si)
            Sf = (U * np.maximum(ev, 1e-3)[:, None, :]) @ np.transpose(
                U, (0, 2, 1))
            eye = np.broadcast_to(np.eye(D), Sf.shape)
            worst = max(float(backward_error(
                Sf, side.Sigma_inv.cpu().numpy()[live], eye).max(initial=0))
                for side in (cpu, crd))
            out["S"] = worst / (SIGMA_C * D * F64_EPS)
        else:
            name = {"w": "w", "c": "c"}[f]
            got = getattr(crd, name).cpu().numpy()
            want = getattr(cpu, name).cpu().numpy()
            Mtot = len(model.V)
            r = 2.0 * _gamma_n(Mtot + I + S, F64_EPS) * 4
            gam = accs.gamma.cpu().numpy()
            if f == "w":
                V = np.abs(model.V.cpu().numpy())
                terms = (np.abs(want) + 1.5 * (2.0 * gam.sum(1, keepdims=True)
                                               * np.ones_like(gam)).T @ V
                         / max(accs.tot_frames, 1.0))
            else:
                terms = np.abs(want) + 1e-300
            out[f] = _worst(got, want, r * terms)
    return out


SIGMA_C = 16.0    # the floored scatter's reconstruction: SIGMA_C D eps64


def _accs_to(accs, device):
    """A shallow copy of an accumulator object (`Sgmm2Accs`,
    `FmllrSgmm2Accs`) with every tensor on `device`."""
    import copy
    import torch
    out = copy.copy(accs)
    for k, v in vars(accs).items():
        if isinstance(v, torch.Tensor):
            setattr(out, k, v.to(device))
    return out


def sgmm_ebw_card_vs_cpu(model, num, den, card: str = "cuda") -> dict:
    """`update_sgmm2_ebw` (vMwSc) from the same num / den statistics on both
    sides: the v, w and M steps' floored quadratic solves held by their
    backward error against the CPU's floored Q (problems whose floored
    solve improved on both sides; the others counted), the improvements
    reported. -> {"v", "w", "M": ratio to `backward_bound`, "fallback":
    count, "impr": {side: dict}}."""
    import torch
    from kaldi_tpu_torch.sgmm import ebw
    opts = ebw.EbwSgmm2Options()
    out = {"fallback": 0}
    cards = (_accs_to(num, card), _accs_to(den, card))
    mc = model.to(card)
    for name, fn in (("v", ebw.v_problems), ("w", ebw.w_problems),
                     ("M", ebw.M_problems)):
        prob = fn(model, num, den, opts)
        Q, g = prob[0], prob[1]
        prob_c = fn(mc, *cards, opts)
        solve = (ebw._solve_quadratic_matrix if name == "M"
                 else ebw._solve_quadratic)
        dc, ic = solve(*(prob_c[:2]))
        dh, ih = solve(Q, g)
        w, V = torch.linalg.eigh(0.5 * (Q + Q.transpose(-1, -2)))
        floor = torch.clamp(w.max(-1).values, min=0.0) / 1e5
        Qf = (V * torch.maximum(w, floor[:, None])[:, None, :]) \
            @ V.transpose(-1, -2)
        # the first branch taken: the floored solve improved the objective
        live = prob[2].numpy() if len(prob) > 2 else np.ones(len(Q), bool)
        ok = (ih.numpy() > 0) & (ic.cpu().numpy() > 0) & live
        worst = 0.0
        for d in (dh, dc.cpu()):
            X = d.numpy() if name == "M" else d.numpy()[:, None, :]
            B = g.numpy() if name == "M" else g.numpy()[:, None, :]
            be = backward_error(Qf.numpy()[ok], X[ok], B[ok])
            worst = max(worst, float(be.max(initial=0.0)))
        out[name] = worst / backward_bound(Q.shape[-1], 1 if name != "M"
                                           else g.shape[1])
        out["fallback"] += int((~ok & live).sum())
    m_cpu, m_card = model.copy(), model.to(card)
    out["impr"] = {"cpu": ebw.update_sgmm2_ebw(m_cpu, num, den),
                   card: ebw.update_sgmm2_ebw(m_card, *cards)}
    return out


def sgmm_yesno_system(seed: int, device) -> dict:
    """tests/test_sgmm.py's yesno SGMM runs built by the port on `device`:
    RandomState(seed) draws the training and test utterances (2-3 words,
    MFCC + deltas), a monophone at their options, then
    `train_sgmm2_system(SgmmTrainOpts(ubm_gauss=8, phn_dim=8))`; seed 13
    decodes the test set with the GMM and the SGMM through `make_decoder`
    (test_sgmm2_asr_decode), seed 21 also runs bMMI over the yesno HCLG
    and decodes with `BeamSearchDecoder` (test_sgmm2_bmmi_e2e). -> WERs,
    loglikes, objectives, the models."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.dense import make_decoder
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
    from kaldi_tpu_torch.steps.sgmm_steps import (SgmmAm, SgmmMmiOpts,
                                                  SgmmTrainOpts,
                                                  train_sgmm2_bmmi,
                                                  train_sgmm2_system)
    cfg = SGMM_YESNO[seed]
    rng = np.random.RandomState(seed)
    lang = gmm_stack(YESNO_LEXICON, YESNO_ARPA)[0]

    def corpus(prefix, n):
        out = []
        for i in range(n):
            ws = [rng.choice(["YES", "NO"]) for _ in range(rng.randint(2, 4))]
            out.append((f"{prefix}{i}", mfcc_deltas(yesno_synth(ws, rng),
                                                    device), ws))
        return out

    train, test = corpus("u", cfg["train"]), corpus("t", cfg["test"])
    gmm = train_mono(lang, train, MonoTrainOpts(**SGMM_YESNO_MONO),
                     device=device)
    sam, likes = train_sgmm2_system(gmm, train, SgmmTrainOpts(
        ubm_gauss=8, phn_dim=8, num_iters=cfg["sgmm_iters"]))
    g = arpa_to_g(ArpaLm.parse(YESNO_ARPA), lang.words)
    graph = make_hclg(lang, g, gmm.trans_model, gmm.ctx_dep,
                      self_loop_scale=0.1)
    packed = pack_graph(graph.fst, gmm.trans_model.id2pdf_array)
    bopts = BeamSearchOpts(beam=16.0, max_active=256, acoustic_scale=0.1)
    dec = (BeamSearchDecoder(packed, bopts, device=device) if cfg["bmmi"]
           else make_decoder(packed, bopts, device=device))
    fb, nf = pad_batch([f for _u, f, _w in test])
    refs = [ws for _u, _f, ws in test]

    def wer_of(am):
        res = dec.decode(am.loglikes(fb), nf)
        return wer(refs, [[lang.words.sym(w) for w in r[0]] if r else []
                          for r in res])

    out = dict(gmm=gmm, sgmm=sam, likes=likes, train=train,
               wer_gmm=wer_of(gmm.am),
               wer_sgmm=wer_of(sam))
    if cfg["bmmi"]:
        sam2 = SgmmAm(sam.sgmm.copy(), sam.num_gselect)
        sam2, objs = train_sgmm2_bmmi(gmm, sam2, graph, train,
                                      SgmmMmiOpts(num_iters=2, boost=0.1))
        out.update(bmmi=sam2, objs=objs, wer_bmmi=wer_of(sam2))
    return out


def check_sgmm_yesno(check, what: str, r: dict) -> str:
    """The run's PARITY.md row, as JAX's slow test asserts it: without bMMI
    (test_sgmm2_asr_decode) :36, SGMM <= GMM + 5.0 and < 20.0 with the
    loglike rising; with bMMI (test_sgmm2_bmmi_e2e) :37, the objective not
    falling by more than 1e-3 and WER <= the ML SGMM's."""
    line = (f"GMM {r['wer_gmm']:.2f}, SGMM {r['wer_sgmm']:.2f} (loglike "
            f"{r['likes'][0]:.3f} -> {r['likes'][-1]:.3f})")
    if "objs" not in r:
        check.require(f"{what}: SGMM loglike rises {r['likes']}",
                      r["likes"][-1] > r["likes"][0])
        check.require(f"{what}: SGMM {r['wer_sgmm']:.2f} <= GMM "
                      f"{r['wer_gmm']:.2f} + 5", r["wer_sgmm"]
                      <= r["wer_gmm"] + 5.0)
        check.require(f"{what}: SGMM {r['wer_sgmm']:.2f} < 20",
                      r["wer_sgmm"] < 20.0)
        return line
    check.require(f"{what}: bMMI objective {r['objs']} does not fall",
                  r["objs"][-1] >= r["objs"][0] - 1e-3)
    check.require(f"{what}: bMMI {r['wer_bmmi']:.2f} <= ML "
                  f"{r['wer_sgmm']:.2f}", r["wer_bmmi"] <= r["wer_sgmm"] + 1e-9)
    return line + (f", bMMI {r['wer_bmmi']:.2f} (objective "
                   + ", ".join(f"{o:.5f}" for o in r["objs"]) + ")")


def toy_am(rng, num_pdfs: int = 3, num_gauss: int = 2, dim: int = 4,
           device="cpu"):
    """tests/test_adaptation_extras.py `_toy_am` (its RNG order) as the
    port's AmDiagGmm on `device`."""
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    pdfs = []
    for _ in range(num_pdfs):
        means = rng.randn(num_gauss, dim) * 3
        variances = np.ones((num_gauss, dim)) * (0.5 + rng.rand(num_gauss,
                                                                dim))
        w = rng.rand(num_gauss) + 0.5
        pdfs.append(DiagGmm(w / w.sum(), means, variances))
    return AmDiagGmm(pdfs, device)


def _am_on(am, device):
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    return AmDiagGmm([p.copy() for p in am.pdfs], device)


def _regtree_data(rng, am):
    """test_regression_tree_and_regtree_fmllr's data: 80 frames from each
    gaussian, aligned to its pdf."""
    feats, pdfs = [], []
    for pdf, g in enumerate(am.pdfs):
        for m in range(g.num_gauss):
            feats.append(g.means[m] + rng.randn(80, am.dim)
                         * np.sqrt(g.vars[m]))
            pdfs.extend([pdf] * 80)
    return np.concatenate(feats), np.asarray(pdfs)


def _mllr_terms(am, feats, post):
    """RegtreeMllrStats' (K, G) per gaussian with absolute values, the
    frames weighted by post [T, G]: -> K [G, D, D+1], G [G, D, D+1, D+1]."""
    mu = np.concatenate([g.means for g in am.pdfs])
    iv = 1.0 / np.concatenate([g.vars for g in am.pdfs])
    xi = np.abs(np.concatenate([mu, np.ones((len(mu), 1))], axis=1))
    gx = post.T @ np.abs(feats)
    return (np.einsum("gd,gp->gdp", gx * iv, xi),
            np.einsum("gd,gp,gq->gdpq", post.sum(0)[:, None] * iv, xi, xi))


def adapt_card_vs_cpu(card: str = "cuda") -> dict:
    """tests/test_adaptation_extras.py's and test_fmllr_raw.py's inputs
    through the port's adaptation transforms on the CPU and on `card`, each
    held by its arithmetic: -> {check: ratio to its bound (<= 1)}."""
    import torch
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.ops.delta import splice_frames
    from kaldi_tpu_torch.transform import basis_fmllr as bf
    from kaldi_tpu_torch.transform import fmllr_raw as fr
    from kaldi_tpu_torch.transform import regtree as rt
    from kaldi_tpu_torch.transform.fmllr import FmllrStats
    from kaldi_tpu_torch.transform.hlda import HldaStats, estimate_hlda
    from kaldi_tpu_torch.transform.lvtln import LinearVtln
    from kaldi_tpu_torch.nnet.optim import adam, apply_updates
    out = {}
    dev = ("cpu", card)
    r = 2.0 * _gamma_n(4000, F64_EPS)

    # MLLR (test_mllr_recovers_mean_shift)
    rng = np.random.RandomState(0)
    am = toy_am(rng)
    D = am.dim
    shift = rng.randn(D) * 0.8
    data = []
    for g in am.pdfs:
        for m in range(g.num_gauss):
            x = g.means[m] + shift + rng.randn(400, D) * np.sqrt(g.vars[m])
            p = np.zeros((400, g.num_gauss))
            p[:, m] = 1.0
            data.append((x, g.means, g.vars, p))
    st = {d: rt.MllrStats(D, d) for d in dev}
    for d in dev:
        for args in data:
            st[d].accumulate(*args)
    tK = sum(np.abs(p).T @ np.abs(x) for x, _m, _v, p in data)
    out["MLLR stats"] = max(
        _worst(st[card].K.cpu().numpy(), st["cpu"].K.numpy(),
               r * np.abs(st["cpu"].K.numpy()) + r * tK.max()),
        _worst(st[card].G.cpu().numpy(), st["cpu"].G.numpy(),
               r * np.abs(st["cpu"].G.numpy())))
    eye = np.eye(D + 1)
    A = np.transpose(st["cpu"].G.numpy() + 1e-8 * eye, (0, 2, 1))
    out["MLLR solve"] = max(float(backward_error(
        A, rt.estimate_mllr(st[d]).cpu().numpy()[:, None, :],
        st["cpu"].K.numpy()[:, None, :]).max()) for d in dev) \
        / backward_bound(D + 1, 1)

    # regression tree (test_regression_tree_and_regtree_fmllr)
    rng = np.random.RandomState(1)
    am = {"cpu": toy_am(rng, num_pdfs=4, num_gauss=2, dim=3)}
    am[card] = _am_on(am["cpu"], card)
    feats, pdfs = _regtree_data(rng, am["cpu"])
    tree = {d: rt.RegressionTree(am[d], num_base_classes=4, device=d)
            for d in dev}
    out["tree equal"] = float(tree["cpu"].parent != tree[card].parent or
                              np.any(tree["cpu"].gauss2leaf
                                     != tree[card].gauss2leaf))
    post = [[(int(p), 1.0)] for p in pdfs]
    acc = {d: rt.RegtreeStats(tree[d], 3) for d in dev}
    macc = {d: rt.RegtreeMllrStats(tree[d], 3) for d in dev}
    for d in dev:
        acc[d].accumulate(am[d], feats, post)
        macc[d].accumulate(am[d], feats, post)
    pb = posterior_bound(am["cpu"], am[card], feats, pdfs)
    g2l = tree["cpu"].gauss2leaf
    worst = 0.0
    for leaf in tree["cpu"].leaves:
        sel = (g2l == leaf)[None, :]
        b = fmllr_term_scale(am["cpu"], feats, pdfs, pb["bound"] * sel)
        s = fmllr_term_scale(am["cpu"], feats, pdfs,
                             _aligned_mask(am["cpu"], pdfs) * sel)
        for f in ("K", "G"):
            worst = max(worst, _worst(
                getattr(acc[card].stats[leaf], f),
                getattr(acc["cpu"].stats[leaf], f),
                getattr(b, f) + r * getattr(s, f)))
    out["regtree fMLLR stats"] = worst
    kb, gb = _mllr_terms(am["cpu"], feats, pb["bound"])
    ks, gs = _mllr_terms(am["cpu"], feats, _aligned_mask(am["cpu"], pdfs))
    oh = tree["cpu"].leaf_onehot().numpy()
    out["regtree MLLR stats"] = max(
        _worst(macc[card].K.cpu().numpy(), macc["cpu"].K.numpy(),
               np.einsum("gl,gdp->ldp", oh, kb + r * ks) + 1e-300),
        _worst(macc[card].G.cpu().numpy(), macc["cpu"].G.numpy(),
               np.einsum("gl,gdpq->ldpq", oh, gb + r * gs) + 1e-300))
    by_leaf = {leaf: np.concatenate([np.eye(3) * 1.1, np.full((3, 1), 0.1)],
                                    1) for leaf in tree["cpu"].leaves[:2]}
    ll = {d: rt.regtree_fmllr_loglikes(am[d], tree[d], by_leaf, feats)
          .cpu().numpy() for d in dev}
    xa = np.abs(feats) * 1.2 + 0.2
    mu = np.concatenate([g.means for g in am["cpu"].pdfs])
    iv = 1.0 / np.concatenate([g.vars for g in am["cpu"].pdfs])
    terms = (xa @ (np.abs(mu) * iv).T + 0.5 * (xa * xa) @ iv.T
             + 0.5 * (mu * mu * iv).sum(1) + 10.0).max(1, keepdims=True)
    out["regtree loglikes"] = _worst(ll[card], ll["cpu"], r * terms)

    # basis fMLLR (test_basis_fmllr)
    rng = np.random.RandomState(2)
    dim = 3
    g = DiagGmm(np.ones(2) / 2, rng.randn(2, dim) * 2, np.ones((2, dim)))

    def spk_stats(n, A, b):
        s = FmllrStats(dim)
        for m in range(2):
            x = (g.means[m] + rng.randn(n, dim)) @ A.T + b
            p = np.zeros((n, 2))
            p[:, m] = 1.0
            s.accumulate(x, g.means, g.vars, p)
        return s

    train = [spk_stats(150, np.eye(dim) + rng.randn(dim, dim) * 0.1,
                       rng.randn(dim) * 0.3) for _ in range(12)]
    accus = {d: bf.BasisFmllrAccus(dim, d) for d in dev}
    for s in train:
        for d in dev:
            accus[d].accumulate_from_speaker(s)
    gs_cpu = accus["cpu"].grad_scatter.numpy()
    vmax = np.sqrt(np.diag(gs_cpu))
    out["basis scatter"] = max(
        _worst(accus[card].grad_scatter.cpu().numpy(), gs_cpu,
               r * np.outer(vmax, vmax) * 4 + 1e-300),
        _worst(accus[card].H.cpu().numpy(), accus["cpu"].H.numpy(),
               r * np.abs(accus["cpu"].H.numpy()) + 1e-300))
    basis = {d: bf.estimate_fmllr_basis(accus[d], 6) for d in dev}
    Vb = basis[card].reshape(6, -1).cpu().numpy()
    out["basis orthonormal"] = float(np.abs(
        Vb @ bf._hbar(accus["cpu"]).numpy() @ Vb.T - np.eye(6)).max()) / 1e-8
    test = spk_stats(60, np.eye(dim) * 1.1, np.array([0.5, -0.2, 0.1]))
    W0 = np.concatenate([np.eye(dim), np.zeros((dim, 1))], 1)
    grads = {d: bf._auxf_gradient(torch.as_tensor(W0, device=d),
                                  *bf._stats_on(test, d)).cpu().numpy()
             for d in dev}
    out["basis gradient"] = _worst(grads[card], grads["cpu"],
                                   1e-9 * np.abs(grads["cpu"]).max())
    Bc = basis["cpu"]
    res = {d: bf.compute_basis_fmllr_transform(test, Bc.to(d), eta=0.05)
           for d in dev}
    out["basis transform (auxiliary)"] = abs(
        res[card][2] - res["cpu"][2]) / (LINE_SEARCH_LIMIT * max(
            abs(res["cpu"][2]), 1.0))
    out["basis coefficients equal"] = float(res[card][1] != res["cpu"][1])

    # LVTLN (test_lvtln_selects_matching_warp)
    rng = np.random.RandomState(3)
    dim = 4
    lv = {d: LinearVtln(dim, [0.9, 1.0, 1.1], d) for d in dev}
    maps = {0: np.eye(dim) * 0.8 + 0.05, 1: np.eye(dim),
            2: np.eye(dim) * 1.25 - 0.05}
    X = rng.randn(2000, dim)
    worst = 0.0
    for c, Mc in maps.items():
        for d in dev:
            lv[d].train_class(c, X, X @ Mc.T)
            Gn = X.T @ X + 1e-6 * np.eye(dim)
            worst = max(worst, float(backward_error(
                Gn[None], lv[d].A[c].cpu().numpy()[None],
                (X.T @ (X @ Mc.T)).T[None]).max()))
    out["LVTLN solves"] = worst / backward_bound(dim, dim)
    g1 = DiagGmm(np.ones(1), np.zeros((1, dim)), np.ones((1, dim)))
    xs = rng.randn(500, dim) @ np.linalg.inv(maps[2]).T
    s = FmllrStats(dim)
    s.accumulate(xs, g1.means, g1.vars, np.ones((500, 1)))
    sel = {d: lv[d].select_class(s) for d in dev}
    out["LVTLN class equal"] = float(sel[card][0] != sel["cpu"][0]
                                     or sel["cpu"][0] != 2)
    out["LVTLN auxiliaries"] = _worst(sel[card][2], sel["cpu"][2], 1e-9 * (
        np.abs(sel["cpu"][2]) + 1.0))

    # HLDA (test_hlda_finds_informative_dims)
    rng = np.random.RandomState(4)
    hs = {d: HldaStats(5, d) for d in dev}
    cm = np.zeros((3, 5))
    cm[:, 0] = [-4, 0, 4]
    cm[:, 1] = [3, -3, 0]
    xs = []
    for c in range(3):
        x = cm[c] + rng.randn(500, 5)
        xs.append(np.abs(x))
        for d in dev:
            hs[d].accumulate(x, np.full(500, c), 3)
    xa = np.concatenate(xs)
    out["HLDA stats"] = max(
        _worst(hs[card].total_2nd.cpu().numpy(), hs["cpu"].total_2nd.numpy(),
               r * xa.T @ xa),
        _worst(hs[card].class_mean_acc.cpu().numpy(),
               hs["cpu"].class_mean_acc.numpy(), r * xa.sum(0) + 1e-300))
    hl = {d: estimate_hlda(hs[d], 2) for d in dev}
    out["HLDA (auxiliary)"] = abs(hl[card][1] - hl["cpu"][1]) / (
        LINE_SEARCH_LIMIT * max(abs(hl["cpu"][1]), 1.0))

    # raw fMLLR (test_fmllr_raw_recovers_distortion)
    rng = np.random.RandomState(0)
    d_raw, L, R, Dm = 3, 1, 1, 4
    proj = rng.randn(Dm, (L + R + 1) * d_raw) * 0.4
    Tmat = np.concatenate([proj, np.zeros((Dm, 1))], axis=1)
    clean = rng.randn(800, d_raw) * 1.5 + rng.randn(d_raw)
    y = splice_frames(torch.as_tensor(clean), L, R).numpy() @ proj.T
    pid = (y[:, 0] > np.median(y[:, 0])).astype(int)
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    am_r = {"cpu": AmDiagGmm([DiagGmm(np.ones(1), y[pid == c].mean(0)[None],
                                      y[pid == c].var(0)[None] + 1e-3)
                              for c in (0, 1)], "cpu")}
    am_r[card] = _am_on(am_r["cpu"], card)
    distorted = clean @ (np.eye(d_raw) * 1.3).T + np.array([0.5, -0.3, 0.2])
    accs = {d: fr.FmllrRawAccs(d_raw, L, R, d) for d in dev}
    for d in dev:
        accs[d].accumulate_from_alignment(am_r[d], distorted[:400], Tmat,
                                          pid[:400])
    st = {d: accs[d].stacked() for d in dev}
    out["raw accumulators"] = max(
        float((st[card][i].cpu() - st["cpu"][i]).abs().max()
              / (2 * F32_EPS * st["cpu"][i].abs().max() + 1e-30))
        for i in range(4))
    # one Adam step from the same accumulators (the CPU's, copied over)
    X, mu, iv, gam = st["cpu"]
    beta = accs["cpu"].beta()
    W1 = {}
    for d in dev:
        W = torch.as_tensor(W0, dtype=torch.float32, device=d) \
            .requires_grad_(True)
        args = [a.to(d) for a in (X, torch.as_tensor(Tmat, dtype=torch.float32),
                                  mu, iv, gam)]
        (-fr.fmllr_raw_auxf(W, *args, beta, d_raw, L + R + 1)).backward()
        tx = adam(0.03)
        upd, _s = tx.update({"W": W.grad}, tx.init({"W": W.detach()}))
        W1[d] = apply_updates({"W": W.detach()}, upd)["W"].cpu().numpy()
    out["raw one Adam step"] = _worst(W1[card], W1["cpu"], RAW_STEP_LIMIT
                                      * np.abs(W1["cpu"]).max())
    accs_c = fr.FmllrRawAccs(d_raw, L, R, card)
    accs_c._chunks = [tuple(a.to(card) for a in c)
                      for c in accs["cpu"]._chunks]
    run = {"cpu": fr.estimate_fmllr_raw(accs["cpu"], Tmat, 300, 0.03),
           card: fr.estimate_fmllr_raw(accs_c, Tmat, 300, 0.03)}
    out["raw Adam run (objective)"] = abs(run[card][1] - run["cpu"][1]) / (
        RAW_RUN_LIMIT * abs(run["cpu"][1]))
    out["raw W difference (reported)"] = float(np.abs(
        run[card][0] - run["cpu"][0]).max())
    return out


def sgmm_extras_card_vs_cpu(su: dict, card: str = "cuda") -> dict:
    """SGMM fMLLR, gpost, the pre-transform, the fMLLR basis and the state
    distances of `sgmm_small_setup`'s model (after the ML updates "vc",
    "Mc") on the CPU and `card`. -> {check: ratio to its bound}."""
    from kaldi_tpu_torch.sgmm import Sgmm2Accs, update_sgmm2
    from kaldi_tpu_torch.sgmm import prexform as px
    from kaldi_tpu_torch.sgmm.fmllr import (FmllrSgmm2Accs,
                                            estimate_sgmm2_fmllr)
    from kaldi_tpu_torch.sgmm.gpost import compute_gpost
    m = su["model"].copy()
    feats, post = su["feats"], su["post"]
    for f in ("vc", "Mc"):
        a = Sgmm2Accs(m)
        a.accumulate(m, feats, post, 4)
        update_sgmm2(m, a, f)
    occ = a.state_occs()
    side = {"cpu": m, "card": m.to(card)}
    out = {}
    bad = feats @ (np.eye(4) * 0.7).T + 0.8
    fa = {}
    for d, md in side.items():
        fa[d] = FmllrSgmm2Accs(md)
        fa[d].accumulate(md, bad, post)
    xa = np.concatenate([np.abs(bad), np.ones((len(bad), 1))], 1)
    Gt = xa.T @ xa
    Kt = (np.abs(m.Sigma_inv.numpy()).sum(0) @ np.abs(m.means().numpy())
          .max((0, 1))[:, None]) * xa.sum(0)[None]
    r = 1e-9
    out["SGMM fMLLR stats"] = max(
        _worst(fa["card"].K.cpu().numpy(), fa["cpu"].K.numpy(), r * Kt),
        _worst(fa["card"].G.cpu().numpy(), fa["cpu"].G.numpy(),
               r * Gt[None]),
        abs(fa["card"].beta - fa["cpu"].beta) / (r * len(bad)))
    fa_on = {"cpu": fa["cpu"], "card": _accs_to(fa["cpu"], card)}
    gr = {d: px.fmllr_grad_at_identity(fa_on[d], side[d]).cpu().numpy()
          for d in side}
    out["SGMM fMLLR gradient"] = _worst(gr["card"], gr["cpu"], 1e-9 * np.abs(
        gr["cpu"]).max())
    est = {d: estimate_sgmm2_fmllr(fa_on[d], side[d]) for d in side}
    out["SGMM fMLLR (auxiliary)"] = abs(est["card"][1] - est["cpu"][1]) / (
        LINE_SEARCH_LIMIT * max(abs(est["cpu"][1]), 1.0))
    pre = {d: [t.cpu().numpy() for t in px.compute_prexform(side[d], occ)]
           for d in side}
    out["pre-transform"] = max(_worst(a, b, 1e-9 * np.abs(b).max())
                               for a, b in zip(pre["card"], pre["cpu"]))
    dist = {d: px.state_distances(side[d], occ).cpu().numpy() for d in side}
    out["state distances"] = _worst(dist["card"], dist["cpu"],
                                    1e-9 * np.abs(dist["cpu"]).max())
    fb = {}
    for d in side:
        a2 = FmllrSgmm2Accs(side[d])
        a2.accumulate(side[d], su["spk_feats"], su["spk_post"])
        fb[d] = [fa_on[d], a2]
    basis = {d: px.estimate_fmllr_basis(side[d], fb[d], 4).cpu().numpy()
             for d in side}
    cos = np.abs((basis["card"][0] * basis["cpu"][0]).sum())
    out["fMLLR basis (top direction)"] = abs(1.0 - cos) / 1e-9
    gp = {d: compute_gpost(side[d], feats[:60], post[:60], 3) for d in side}
    worst, sets = 0.0, 0
    for fc, fp in zip(gp["card"], gp["cpu"]):
        for (jc, gc, pc), (jp, gq, pq) in zip(fc, fp):
            if jc != jp or set(gc) != set(gq):
                sets += 1
                continue
            oc, op = np.argsort(gc), np.argsort(gq)
            worst = max(worst, _worst(pc[:, oc], pq[:, op],
                                      2 * F32_EPS * np.abs(pq) + 1e-12))
    out["gpost"] = worst
    out["gpost sets differ"] = float(sets)
    return out



def sgmm_loglikes_card_vs_cpu(model, x, K: int, spk=None,
                              card: str = "cuda") -> float:
    """`loglikes_matrix` on both sides over the same frames: the largest
    difference over 2 gamma_n (n = D^2 + S + I) of its terms' magnitude
    (|n_jmi| + |z||v| + |x' Sigma^-1 x| / 2, bounded per frame)."""
    a = model.loglikes_matrix(x, K, spk).numpy()
    mc = model.to(card)
    sc = None if spk is None else type(spk)(spk.v.to(card))
    b = mc.loglikes_matrix(x, K, sc).cpu().numpy()
    I, D, S = model.M.shape
    xa = np.abs(np.asarray(x, np.float64))
    Sinv = np.abs(model.Sigma_inv.numpy())
    quad = 0.5 * np.einsum("td,ide,te->ti", xa, Sinv, xa).max(1)
    z = xa @ np.abs(model.SinvM.numpy()).transpose(1, 0, 2).reshape(D, -1)
    zv = z.max(1) * np.abs(model.V.numpy()).sum(1).max()
    nrm = np.abs(model.normalizers().numpy()).max()
    terms = (quad + zv + nrm + np.abs(a).max(1))[:, None]
    return _worst(b, a, 2.0 * _gamma_n(D * D + S + I, F64_EPS) * 4 * terms)


def phase_adapt_sgmm_small():
    """Phase 27: the adaptation transforms and SGMM2 small, card vs CPU,
    every check by a bound its arithmetic sets, each ratio logged."""
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.sgmm import Sgmm2Accs, estimate_speaker_vector
    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    check = _Limits()
    su = sgmm_small_setup("cpu")
    m, feats, post = su["model"], su["feats"], su["post"]
    K = SGMM_SMALL["num_gselect"]
    spk = estimate_speaker_vector(m, su["spk_feats"], su["spk_post"], K)
    spk_c = estimate_speaker_vector(m.to("cuda"), su["spk_feats"],
                                    su["spk_post"], K)
    r_spk = _worst(spk_c.v.cpu().numpy(), spk.v.numpy(),
                   1e-9 * np.abs(spk.v.numpy()).max())
    check("speaker vector over 1e-9 of its largest entry", r_spk, 1.0)
    ll = {"plain": sgmm_loglikes_card_vs_cpu(m, feats, K),
          "speaker": sgmm_loglikes_card_vs_cpu(m, su["spk_feats"], K, spk)}
    for k, v in ll.items():
        check(f"loglikes_matrix ({k}) over its bound", v, 1.0)
    lines = []
    for what, x, pst, sp in (("plain", feats, post, None),
                             ("speaker", su["spk_feats"], su["spk_post"],
                              spk)):
        e = sgmm_stats_card_vs_cpu(m, x, pst, K, sp)
        for k in ("gamma", "y", "Y", "Q", "S_centered", "tot_like"):
            check(f"accumulation ({what}) {k} over its bound", e[k], 1.0)
        check(f"accumulation ({what}) unjustified gselect flips",
              e["unjustified"], 0)
        lines.append(f"{what}: " + ", ".join(
            f"{k} {e[k]:.3f}" for k in ("gamma", "y", "Y", "Q", "S_centered",
                                        "tot_like"))
            + f", gselect flips {e['flips']}, loglikes {e['ll']:.2e} of "
            f"their scale")
        if what == "plain":
            accs = e["accs"]
    up = sgmm_update_card_vs_cpu(m, accs, "vMwSc")
    for k, v in up.items():
        check(f"update {k} over its bound", v, 1.0)
    # EBW on num (alignment) / den (the model's own state posteriors)
    llm = m.loglikes_matrix(feats, K).numpy()
    p = np.exp(llm - llm.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    den_post = [[(j, float(p[t, j])) for j in range(3) if p[t, j] > 1e-6]
                for t in range(len(feats))]
    num, den = Sgmm2Accs(m), Sgmm2Accs(m)
    num.accumulate(m, feats, post, K)
    den.accumulate(m, feats, den_post, K)
    eb = sgmm_ebw_card_vs_cpu(m, num, den)
    for k in ("v", "w", "M"):
        check(f"EBW {k} solves over their bound", eb[k], 1.0)
    ex = sgmm_extras_card_vs_cpu(su)
    for k, v in ex.items():
        check(f"{k}", v, 1.0 if "differ" not in k else 0.0)
    log("  (i) SGMM2 core at tests/test_sgmm.py's sgmm_setup (I 4, D 4, S "
        f"5, T 2, {int(m.offsets[-1])} substates, gselect {K}), ratios to "
        f"their bounds: speaker vector {r_spk:.3f}; loglikes_matrix "
        + ", ".join(f"{k} {v:.3f}" for k, v in ll.items()) + "; statistics "
        + "; ".join(lines) + "; updates " + ", ".join(
            f"{k} {v:.3f}" for k, v in up.items())
        + f"; EBW solves v {eb['v']:.3f}, w {eb['w']:.3f}, M {eb['M']:.3f} "
        f"({eb['fallback']} fell back), improvements card "
        + str({k: round(v, 6) for k, v in eb["impr"]["cuda"].items()})
        + " CPU " + str({k: round(v, 6) for k, v in eb["impr"]["cpu"].items()})
        + "; " + ", ".join(f"{k} {v:.3f}" for k, v in ex.items()))
    ad = adapt_card_vs_cpu()
    for k, v in ad.items():
        if "reported" in k:
            continue
        check(k, v, 0.0 if ("equal" in k) else 1.0)
    log("  (ii) adaptation transforms at tests/test_adaptation_extras.py's "
        "and test_fmllr_raw.py's inputs, ratios to their bounds: "
        + ", ".join(f"{k} {v:.3g}" for k, v in ad.items()))
    # (iii) the yesno SGMM runs on both devices, PARITY.md:36-37
    for seed in SGMM_YESNO:
        res = {}
        for d in ("cuda", "cpu"):
            t = time.perf_counter()
            res[d] = sgmm_yesno_system(seed, d)
            res[d]["secs"] = time.perf_counter() - t
        lines = [f"{d} " + check_sgmm_yesno(check, f"yesno {seed} {d}",
                                            res[d])
                 + f" in {res[d]['secs']:.3f} s" for d in res]
        sg = res["cpu"]["sgmm"]
        e = sgmm_stats_card_vs_cpu(
            sg.sgmm, np.concatenate([f for f, _p in _aligned_yesno(res)]),
            _yesno_entries(res), sg.num_gselect)
        for k in ("gamma", "y", "Y", "Q", "S_centered", "tot_like"):
            check(f"yesno {seed} accumulation {k} over its bound", e[k], 1.0)
        check(f"yesno {seed} unjustified gselect flips", e["unjustified"], 0)
        log(f"  (iii) yesno SGMM (RandomState {seed}): " + "; ".join(lines)
            + "; the CPU SGMM's statistics card vs CPU (I 8, D 39): "
            + ", ".join(f"{k} {e[k]:.3f}" for k in (
                "gamma", "y", "Y", "Q", "S_centered", "tot_like"))
            + f", gselect flips {e['flips']}")
    check.require(f"qaffine launched {q.launches} times", q.launches == 0)
    check.require(f"the gather launched {tg.launches} times", tg.launches == 0)
    check.done("phase 27")
    log(f"  phase 27 took {time.perf_counter() - t0:.3f} s; neither kernel "
        f"launched")


def _aligned_yesno(res: dict) -> list:
    """The CPU yesno system's training alignments [(feats, pdfs)]."""
    from kaldi_tpu_torch.steps.tdnn import align_with_gmm
    r = res["cpu"]
    if "aligned" not in r:
        r["aligned"] = align_with_gmm(r["gmm"], r["train"])
    return r["aligned"]


def _yesno_entries(res: dict) -> tuple:
    pdfs = np.concatenate([p for _f, p in _aligned_yesno(res)])
    return (np.arange(len(pdfs)), pdfs, np.ones(len(pdfs)))


# ------------------------------------------ rescoring and keyword search

# tests/test_const_arpa.py's three LM shapes, written out (the reference's
# src/lm fixtures are not in this tree): a plain trigram (after
# input.arpa), histories without their own entries (missing_backoffs.arpa)
# and a 4-gram with backoffs on entries that extend nothing and a history
# whose prefix is no entry (unused_backoffs.arpa); words a, b, c
ARPA_SHAPES = {
    "plain": "\\data\\\nngram 1=5\nngram 2=4\nngram 3=3\n\n\\1-grams:\n"
             "-1.234679\ta\t-0.3\n-1.456783\tb\t-0.25\n-1.9\tc\n"
             "-99\t<s>\t-0.5\n-1.333333\t</s>\n\n\\2-grams:\n"
             "-0.45678\ta b\t-0.23\n-0.30490\t<s> a\t-0.42\n"
             "-0.34567\tb </s>\n-0.6\tb a\t-0.1\n\n\\3-grams:\n"
             "-0.34958\t<s> a b\n-0.23940\ta b </s>\n-0.2\tb a b\n\n"
             "\\end\\\n",
    "missing_backoffs": "\\data\\\nngram 1=5\nngram 2=3\nngram 3=4\n\n"
             "\\1-grams:\n-1.0\ta\t-0.5\n-1.2\tb\t-0.3\n-1.5\tc\n"
             "-99\t<s>\t-0.4\n-1.1\t</s>\n\n\\2-grams:\n-0.3\ta b\t-0.2\n"
             "-0.6\tb c\n-0.5\t<s> b\n\n\\3-grams:\n-0.2\t<s> a b\n"
             "-0.1\ta b c\n-0.4\tc a b\n-0.7\tc b </s>\n\n\\end\\\n",
    "unused_backoffs": "\\data\\\nngram 1=5\nngram 2=5\nngram 3=3\n"
             "ngram 4=2\n\n\\1-grams:\n-1.0\ta\t-0.5\n-1.2\tb\t-0.3\n"
             "-1.5\tc\t-0.2\n-99\t<s>\t-0.4\n-1.1\t</s>\n\n\\2-grams:\n"
             "-0.3\ta b\t-0.2\n-0.6\tb c\t-0.7\n-0.5\t<s> a\t-0.1\n"
             "-0.4\tc a\t-0.6\n-0.9\tb </s>\n\n\\3-grams:\n"
             "-0.2\t<s> a b\t-0.3\n-0.15\ta b c\t-0.4\n-0.35\tb c a\n\n"
             "\\4-grams:\n-0.1\t<s> a b c\n-0.05\tc a b </s>\n\n\\end\\\n",
}
# test_ubm_biglm.py:92-138's LMs over the words a and b
BIGLM_UNIGRAM = ("\\data\\\nngram 1=4\n\n\\1-grams:\n-0.30103\ta\n"
                 "-0.30103\tb\n-99\t<s>\n-0.1\t</s>\n\n\\end\\\n")
BIGLM_BIGRAM = ("\\data\\\nngram 1=4\nngram 2=2\n\n\\1-grams:\n-0.5\ta -0.1\n"
                "-0.5\tb -0.1\n-99\t<s> -0.1\n-0.5\t</s>\n\n\\2-grams:\n"
                "-0.05\tb a\n-3.0\ta b\n\n\\end\\\n")
# bench.py:459-470: the trigram over the bench graph's 60,000 words
BENCH_LM = dict(vocab=60000, n_bigrams=700_000, n_trigrams=750_000, seed=7,
                ngrams=1_130_773)
RESCORE_LM_SCALE = 0.5                  # bench.py:475
AUDIT_NBEST = 50                        # bench.py:517
LADDER_TRIGRAM = dict(n_bigrams=3000, n_trigrams=6000, seed=7)
# the rung whose lattices go through MBR and the lmwt sweep (host n-best
# and best paths): on an NVIDIA H100 80GB HBM3 (700 W) run the TDNN's
# lattices held 414,273 arcs against the LDA+MLLT's 34,838, and the two
# passes over them took 126 s of phase 30
SWEEP_RUNG = "lda_mllt"
# the sweep's grid, cut for the script's time from score_lattices'
# defaults (lmwt 5-17 by 2, wip 0, 0.5, 1) to phase 38's score.sh points
SWEEP_LMWT = (7, 10, 13)
SWEEP_WIP = (0.0, 0.5)
KWS_PHRASES = 40
RIR = dict(taps=4800, rt60=0.3, snr_db=15.0, seed=29)


def symbol_table(words, extra=()):
    """The port's SymbolTable: <eps>, then `words`, then `extra`."""
    from kaldi_tpu_torch.fst.fst import SymbolTable
    t = SymbolTable()
    for w in list(words) + list(extra):
        t.add(w)
    return t


def shape_lm(name: str):
    """ARPA_SHAPES[name] as a ConstArpaLm over <eps> a b c <s> </s> #0."""
    from kaldi_tpu_torch.lm.arpa import ArpaLm
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
    return ConstArpaLm(ArpaLm.parse(ARPA_SHAPES[name]),
                       symbol_table(["a", "b", "c", "<s>", "</s>", "#0"]))


def lattices_equal(a, b) -> bool:
    """The same arc arrays, start and finals (in order)."""
    x, y = a.to_arrays(), b.to_arrays()
    return x[0] == y[0] and all(np.array_equal(p, q) for p, q in
                                zip(x[1:], y[1:])) and a.start == b.start \
        and list(a.finals.items()) == list(b.finals.items())


def step_batch_card_vs_cpu(clm, n: int = 20000, seed: int = 0,
                           card: str = "cuda") -> dict:
    """A seeded batch of n queries over every state, with word ids inside,
    straddling and beyond the packed column domain: `step_batch` and
    `final_cost_batch` on `card` against the CPU, and the CPU against the
    scalar `step` on every (n // 500)-th query. -> counts of queries that
    differ (0 everywhere: the costs are exact)."""
    clm._batch_tables()
    W = clm._wspan
    rng = np.random.RandomState(seed)
    states = rng.randint(0, clm.num_states, n)
    words = np.concatenate([rng.randint(-4, W + 8, n - 40),
                            np.arange(W - 5, W + 15),
                            rng.randint(W, 4 * W, 20)]).astype(np.int64)
    nc, cc = clm.step_batch(states, words, device=card)
    nh, ch = clm.step_batch(states, words, device="cpu")
    fin = [clm.final_cost_batch(states[:500], device=d) for d in (card,
                                                                  "cpu")]
    return {"next states": int(np.sum(nc != nh)),
            "costs": int(np.sum(cc != ch)),
            "finals": int(np.sum(fin[0] != fin[1])),
            "scalar step": sum(
                clm.step(int(states[i]), int(words[i])) != (nh[i], ch[i])
                for i in range(0, n, max(n // 500, 1)))}


def rescore_card_vs_cpu(lats, clm, lm_scale: float, card: str = "cuda"):
    """The batch rescorer over `lats` (None skipped, the rest in one
    `lattice_lmrescore_const_arpa_many` call) on `card` and on the CPU.
    -> (card lattices, CPU lattices, card seconds, CPU seconds, lattices
    that differ)."""
    import torch
    from kaldi_tpu_torch.lm.const_arpa import \
        lattice_lmrescore_const_arpa_many as rescore
    live = [lat for lat in lats if lat is not None]
    out, secs = {}, {}
    for dev in (card, "cpu"):
        clm.device_tables(dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out[dev] = rescore(live, clm, lm_scale, device=dev)
        secs[dev] = time.perf_counter() - t
    return out[card], out["cpu"], secs[card], secs["cpu"], sum(
        not lattices_equal(a, b) for a, b in zip(out[card], out["cpu"]))


def hub_lattices():
    """Lattices of the 40-word star hub graph from the port's CSR decoder
    with records on the CPU, on seeded loglikes: -> (word symbols, 3
    lattices)."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.lat.generate import raw_lattice_from_decode
    dec = CsrBeamDecoder(star_hub_graph(40), CsrBeamOpts(
        beam=1e9, max_active=32, expand_budget=256, hub_threshold=8,
        rec_cap=16, rec_f16=True), device="cpu")
    ll = np.random.RandomState(0).randn(3, 12, 41).astype(np.float32)
    nf = np.array([12, 9, 12], np.int32)
    raw = dec.decode_raw(ll, nf)
    return ([f"w{k}" for k in range(1, 41)],
            [raw_lattice_from_decode(dec, raw, nf, b, 6.0) for b in range(3)])


def random_topo_lattices(seed: int, n: int, words: list) -> list:
    """tests/test_const_arpa.py:216's random topologically sorted
    lattices over `words` (0 is eps; an id past the LM is out of
    vocabulary)."""
    from kaldi_tpu_torch.lat.lattice import Lattice
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        m = int(rng.randint(5, 14))
        lat = Lattice()
        for _ in range(m):
            lat.add_state()
        lat.start = 0
        for _ in range(int(rng.randint(m, 3 * m))):
            s = int(rng.randint(0, m - 1))
            lat.add_arc(s, int(rng.randint(1, 9)),
                        words[int(rng.randint(len(words)))],
                        float(np.round(rng.rand(), 3)),
                        float(np.round(rng.rand(), 3)),
                        int(rng.randint(s + 1, m)))
        lat.set_final(m - 1, 0.25, 0.0)
        if int(rng.randint(2)):
            lat.set_final(int(rng.randint(1, m)), 0.5, 0.0)
        out.append(lat)
    return out


def topo_sorted(lat):
    """`lat` with its states renumbered in topological order (every arc
    src < dst), the same paths and weights: what the batch rescorer takes
    on its device (a composed lattice need not be sorted)."""
    from kaldi_tpu_torch.lat.lattice import Lattice
    order = lat.topological_order()
    new = np.empty(lat.num_states, np.int64)
    new[order] = np.arange(lat.num_states)
    n, src, il, ol, gc, ac, dst = lat.to_arrays()
    return Lattice.from_arrays(n, new[src], il, ol, gc, ac, new[dst],
                               start=int(new[lat.start]),
                               finals={int(new[s]): f
                                       for s, f in lat.finals.items()})


def biglm_setup(device) -> dict:
    """tests/test_ubm_biglm.py:92-138: a two-word lexicon, its unigram G
    and HCLG, the bigram as a ConstArpaLm, seeded loglikes (B 3, T 24),
    the padded decoder at beam 1e9 on `device`."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
    from kaldi_tpu_torch.tree.context_dep import MonophoneContextDependency
    lang = prepare_lang(Lexicon.parse("a AY\nb BE"), ["SIL"], "SIL",
                        num_sil_states=1, num_nonsil_states=2)
    ctx = MonophoneContextDependency.from_topo(lang.topo)
    tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    g = arpa_to_g(ArpaLm.parse(BIGLM_UNIGRAM), lang.words)
    packed = pack_graph(make_hclg(lang, g, tm, ctx, self_loop_scale=0.1).fst,
                        tm.id2pdf_array)
    rng = np.random.RandomState(4)
    return dict(lang=lang, g=g, packed=packed,
                clm=ConstArpaLm(ArpaLm.parse(BIGLM_BIGRAM), lang.words),
                ll=(rng.randn(3, 24, tm.num_pdfs) * 2).astype(np.float32),
                nf=np.array([24, 18, 24], np.int32),
                dec=BeamSearchDecoder(packed, BeamSearchOpts(
                    beam=1e9, max_active=128, acoustic_scale=0.1),
                    device=device))


def biglm_vs_exact(card: str = "cuda") -> dict:
    """decode_biglm with its decoder on `card` (lattice beam 100) against
    the unpruned host oracle decode_biglm_exact (test_ubm_biglm.py:92):
    -> word mismatches, None mismatches and the largest cost gap."""
    from kaldi_tpu_torch.decoder.biglm import decode_biglm, decode_biglm_exact
    s = biglm_setup(card)
    bo = s["lang"].words["#0"]
    fast = decode_biglm(s["dec"], s["ll"], s["nf"], s["g"], bo, s["clm"],
                        lattice_beam=100.0)
    exact = decode_biglm_exact(s["packed"], s["ll"], s["nf"], s["g"], bo,
                               s["clm"])
    both = [(f, e) for f, e in zip(fast, exact) if f and e]
    return {"none": sum((f is None) != (e is None)
                        for f, e in zip(fast, exact)),
            "words": sum(f[0] != e[0] for f, e in both),
            "cost gap": max((abs(f[1] - e[1]) for f, e in both),
                            default=0.0), "n": len(both)}


def pitch_signals() -> list:
    """tests/test_signal_pitch.py's signals at 16 kHz: tones at 120, 220
    and 330 Hz (0.6 s) and 150 Hz (0.5 s), and noise (RandomState(2))."""
    out = []
    for f0, secs in ((120.0, 0.6), (220.0, 0.6), (330.0, 0.6),
                     (150.0, 0.5)):
        t = np.arange(int(16000 * secs)) / 16000.0
        out.append((np.sin(2 * np.pi * f0 * t) * 5000).astype(np.float32))
    out.append((np.random.RandomState(2).randn(8000) * 100)
               .astype(np.float32))
    return out


def seeded_rir(taps: int, rt60_s: float, seed: int,
               sr: float = 16000.0) -> np.ndarray:
    """An exponentially decaying noise RIR of `taps` samples falling 60 dB
    over rt60_s, direct path 1."""
    rng = np.random.RandomState(seed)
    t = np.arange(taps) / sr
    rir = rng.randn(taps) * np.exp(-6.908 * t / rt60_s)
    rir[0] = 1.0
    return rir.astype(np.float32)


def fft_conv_bound(x: np.ndarray, h: np.ndarray) -> float:
    """Per-sample bound of |card - CPU| for `fft_convolve`: each side's
    rfft / product / irfft errs by at most (3 a + 2) u (|x|_2 |h|_1 +
    |x|_1 |h|_2) with a = 5 log2(nfft) (an FFT of size N errs by about
    log2 N u of its 2-norm), twice for the two sides."""
    nfft = 1 << (len(x) + len(h) - 2).bit_length()
    a = 5.0 * np.log2(nfft)
    x, h = np.asarray(x, np.float64), np.asarray(h, np.float64)
    return 2 * (3 * a + 2) * F64_EPS * (
        np.linalg.norm(x) * np.abs(h).sum()
        + np.abs(x).sum() * np.linalg.norm(h))


def resample_bound(rs, x) -> np.ndarray:
    """Per-output bound of |card - CPU| for `LinearResample.resample_tensor`:
    a dot of L f64 products, L u sum |x_i f_i| on each side."""
    import copy
    import torch
    rs_abs = copy.copy(rs)
    rs_abs.filters = np.abs(rs.filters)
    mag = rs_abs.resample_tensor(torch.as_tensor(np.abs(np.asarray(
        x, np.float64)))).numpy()
    return 2 * rs.filters.shape[1] * F64_EPS * mag


def nccf_bound(frames: np.ndarray, lags, win: int,
               ballast: float) -> np.ndarray:
    """Per-(frame, lag) bound of |card - CPU| for `_nccf`, to first order:
    each mean-removed sample errs by at most (win + 2) u M (M the window's
    largest |x|), a sum of win products by win u sum |terms|, the square
    root and the division by u of their value; twice for the two
    sides."""
    u = F64_EPS
    f = np.asarray(frames, np.float64)
    a = f[:, :win] - f[:, :win].mean(1, keepdims=True)
    lo = int(lags[0])
    idx = np.arange(len(lags))[:, None] + lo + np.arange(win)[None, :]
    b = f[:, idx]                                            # [T, L, win]
    b = b - b.mean(2, keepdims=True)
    Ma = np.abs(f[:, :win]).max(1)[:, None]
    Mb = np.abs(f[:, idx]).max(2)
    sa, sb = np.abs(a).sum(1)[:, None], np.abs(b).sum(2)
    e1, e2 = (a * a).sum(1)[:, None], (b * b).sum(2)
    num = (a[:, None, :] * b).sum(2)
    da, db = (win + 2) * u * Ma, (win + 2) * u * Mb
    dnum = da * sb + db * sa + win * u * np.abs(a[:, None, :] * b).sum(2)
    de1, de2 = 2 * da * sa + win * u * e1, 2 * db * sb + win * u * e2
    den = np.sqrt(e1 * e2 + ballast + 1e-10)
    dden = (de1 * e2 + e1 * de2 + 3 * u * (e1 * e2 + ballast)) / (2 * den) \
        + u * den
    return 2 * (dnum / den + np.abs(num) * dden / den ** 2
                + u * np.abs(num / den))


def features_card_vs_cpu(waves: list, card: str = "cuda") -> dict:
    """Each wave (16 kHz) through the feature modules on `card` and on the
    CPU. Convolution with RIR's seeded RIR, the 16 -> 8 kHz resampler and
    the pitch tracker's 16 -> 4 kHz one: the f64 results within their
    bounds; the NCCF of the same (CPU-resampled) frames within its bound;
    the Viterbi over lags on the same f32 costs path for path; the whole
    tracker's path (frames differing) and process_pitch's output. ->
    worst ratio to each bound, frame counts, and seconds per device."""
    import torch
    from kaldi_tpu_torch.ops import pitch as P
    from kaldi_tpu_torch.ops.resample import LinearResample
    from kaldi_tpu_torch.ops.signal import fft_convolve
    opts = P.PitchOpts()
    rir = seeded_rir(RIR["taps"], RIR["rt60"], RIR["seed"])
    rs8 = LinearResample(16000.0, 8000.0)
    rs4 = LinearResample(16000.0, opts.resample_freq,
                         filter_cutoff=opts.lowpass_cutoff)
    win, shift = 100, 40
    lags = np.arange(int(opts.resample_freq / opts.max_f0),
                     int(np.ceil(opts.resample_freq / opts.min_f0)) + 1)
    need = win + int(lags[-1])
    r = {"conv": 0.0, "resample 8k": 0.0, "resample 4k": 0.0, "nccf": 0.0,
         "viterbi frames": 0, "pitch frames": 0, "process_pitch": 0.0,
         "frames": 0}

    def both(fn):
        return [fn(d) for d in (card, "cpu")]

    def ratio(got, want, bound):
        return float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                            / np.maximum(bound, 1e-300)))

    for w in waves:
        x64 = np.asarray(w, np.float64)
        c, h = both(lambda d: fft_convolve(
            torch.as_tensor(x64, device=d), torch.as_tensor(
                rir.astype(np.float64), device=d), len(w)).cpu().numpy())
        r["conv"] = max(r["conv"], ratio(c, h, fft_conv_bound(w, rir)))
        for name, rs in (("resample 8k", rs8), ("resample 4k", rs4)):
            c, h = both(lambda d: rs.resample_tensor(torch.as_tensor(
                x64, device=d)).cpu().numpy())
            r[name] = max(r[name], ratio(c, h, resample_bound(rs, x64)))
        x4 = rs4.resample(x64, device="cpu").astype(np.float64)
        T = 1 + (len(x4) - need) // shift
        if T < 2:
            continue
        fr = x4[(np.arange(T) * shift)[:, None] + np.arange(need)]
        ballast = opts.nccf_ballast * (float(np.mean(x4 * x4)) + 1e-10) * win
        c, h = both(lambda d: P._nccf(torch.as_tensor(fr, device=d), lags,
                                      win, ballast).cpu().numpy())
        r["nccf"] = max(r["nccf"], ratio(c, h, nccf_bound(fr, lags, win,
                                                          ballast)))
        costs = (1.0 - (h - opts.soft_min_f0 * (lags / opts.resample_freq)))
        ld = np.log(lags.astype(np.float64))
        trans = opts.penalty_factor * (ld[:, None] - ld[None, :]) ** 2 / \
            opts.delta_pitch ** 0.5
        c, h = both(lambda d: P._viterbi_lags(
            torch.as_tensor(costs, device=d).float(),
            torch.as_tensor(trans, device=d).float()))
        r["viterbi frames"] += int(np.sum(c != h))
        c, h = both(lambda d: P.compute_kaldi_pitch(w, device=d))
        r["pitch frames"] += int(np.sum(c[:, 1] != h[:, 1]))
        r["frames"] += len(h)
        r["process_pitch"] = max(r["process_pitch"], float(np.max(np.abs(
            P.process_pitch(c) - P.process_pitch(h)))))
    return r


def kws_word_posterior_gap(lat, index, words) -> float:
    """The largest |sum of a one-word keyword's unmerged hit posteriors -
    the word's expected count by the lattice's forward-backward| over
    `words`: the search's alpha + arc + beta - tot per arc against
    lattice_forward_backward's arc posteriors."""
    from kaldi_tpu_torch.kws import search_index
    from kaldi_tpu_torch.lat.functions import lattice_forward_backward
    post, _tot, _a, _b = lattice_forward_backward(lat)
    gap = 0.0
    for word in words:
        want = sum(p for (s, i), p in post.items()
                   if lat.arcs[s][i].olabel == word)
        got = sum(h[3] for h in search_index([index], [word],
                                             merge_tolerance=-1))
        gap = max(gap, abs(got - want))
    return gap


def phase_rescore_small() -> None:
    """Phase 29: the const-ARPA LM, the batch rescorer, decode_biglm and
    the feature modules, small, card vs CPU."""
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm, stats
    from kaldi_tpu_torch.lm.synth import synth_trigram_arpa
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    failed = []
    for k, name in enumerate(ARPA_SHAPES):
        r = step_batch_card_vs_cpu(shape_lm(name), 20000, k)
        log(f"  step_batch, {name} LM, 20000 seeded queries (word ids past "
            f"the column domain among them): card vs CPU and CPU vs the "
            f"scalar step, queries that differ {r}")
        if any(r.values()):
            failed.append(f"step_batch on {name}: {r}")
    words, lats = hub_lattices()
    hub_lm = ConstArpaLm(synth_trigram_arpa(words, 300, 300,
                                            rng=np.random.default_rng(3)),
                         symbol_table(words))
    cases = [("hub lattices", lats, hub_lm)] + [
        (f"random lattices, {name} LM", random_topo_lattices(
            k, 8, [1, 2, 3, 0, 99]), shape_lm(name))
        for k, name in enumerate(ARPA_SHAPES)]
    stats.update(lattices=0, levels=0, syncs=0, scalar=0)
    for what, ls, clm in cases:
        for scale in (0.5, 1.0, -1.0):
            _c, _h, _tc, _th, diff = rescore_card_vs_cpu(ls, clm, scale)
            if diff:
                failed.append(f"{what} at scale {scale}: {diff} lattices "
                              f"differ card vs CPU")
    log(f"  batch rescoring of {stats['lattices'] // 2} lattices (hub graph "
        f"decodes and random topological ones) at lm_scale 0.5, 1, -1: "
        f"lattice arrays card == CPU for all; {stats['levels']} BFS "
        f"levels, {stats['syncs']} host syncs on both devices; scalar "
        f"fallbacks {stats['scalar']}")
    b = biglm_vs_exact()
    log(f"  decode_biglm (padded decoder on the card, lattice beam 100) vs "
        f"decode_biglm_exact at test_ubm_biglm.py:92's setup: {b['n']} "
        f"utterances, word mismatches {b['words']}, None mismatches "
        f"{b['none']}, largest cost gap {b['cost gap']:.3e} (limit 1e-3)")
    if b["words"] or b["none"] or b["cost gap"] > 1e-3 or b["n"] < 3:
        failed.append(f"decode_biglm vs exact: {b}")
    t = time.perf_counter()
    f = features_card_vs_cpu(pitch_signals())
    log(f"  features on tests/test_signal_pitch.py's 5 signals, card vs CPU "
        f"(ratios to the bounds of their arithmetic): convolution "
        f"{f['conv']:.3e}, resampling 16 -> 8 kHz {f['resample 8k']:.3e}, "
        f"16 -> 4 kHz {f['resample 4k']:.3e}, NCCF {f['nccf']:.3e}; Viterbi "
        f"frames differing on shared costs {f['viterbi frames']}, whole "
        f"tracker {f['pitch frames']} of {f['frames']}; process_pitch "
        f"within {f['process_pitch']:.3e}; {time.perf_counter() - t:.3f} s")
    bad = [k for k in ("conv", "resample 8k", "resample 4k", "nccf")
           if not f[k] <= 1.0] + [k for k in ("viterbi frames",
                                              "pitch frames") if f[k]]
    if bad:
        failed.append(f"features card vs CPU: {bad} ({f})")
    if q.launches or tg.launches:
        failed.append(f"launches: gather {tg.launches}, qaffine {q.launches}")
    log(f"  launches: gather {tg.launches}, qaffine {q.launches}; phase 29 "
        f"took {time.perf_counter() - t0:.3f} s")
    if failed:
        raise AssertionError("; ".join(failed))


def _best_words(lats) -> list:
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    out = []
    for lat in lats:
        r = lattice_best_path(lat) if lat is not None and \
            lat.num_states else None
        out.append(list(r[0]) if r else [])
    return out


def _lat_wer(refs: list, lats) -> float:
    return wer(refs, _best_words(lats))


def _oracle_wer(refs: list, lats) -> float:
    from kaldi_tpu_torch.lat.align import lattice_oracle
    edits = sum(lattice_oracle(lat, ref)[0] if lat is not None
                else len(ref) for lat, ref in zip(lats, refs))
    return 100.0 * edits / max(sum(len(r) for r in refs), 1)


def kws_phrases(refs_w: list, words) -> set:
    """KWS_PHRASES two-word phrases (word-id pairs) drawn from the
    reference transcripts `refs_w` (word lists)."""
    rng = np.random.RandomState(31)
    phrases: set = set()
    while len(phrases) < KWS_PHRASES:
        ws = refs_w[rng.randint(len(refs_w))]
        k = rng.randint(len(ws) - 1)
        phrases.add((words[ws[k]], words[ws[k + 1]]))
    return phrases


def _kws_refs(ctms: dict, phrases: list) -> dict:
    """{keyword: [(utt, t_begin, t_end)]} from per-utterance ctms: every
    word's occurrences, and each two-word phrase's consecutive pairs."""
    refs: dict = {}
    for u, ctm in ctms.items():
        for w, t0, d in ctm:
            refs.setdefault((w,), []).append((u, t0, t0 + d))
        for (w1, t1, _d1), (w2, t2, d2) in zip(ctm, ctm[1:]):
            if (w1, w2) in phrases:
                refs.setdefault((w1, w2), []).append((u, t1, t2 + d2))
    return refs


def phase_rescore_bench(card: str, lt: dict) -> dict:
    """Phase 30 (a) and (c), which take nothing from the ladder: (a)
    bench.py's trigram rescoring line and its truncation audit on phase
    14's lattices, (c) the feature modules on the bench's test waves."""
    import torch
    from kaldi_tpu_torch.lat.functions import lattice_best_path, nbest
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm, stats
    from kaldi_tpu_torch.lm.const_arpa import \
        lattice_lmrescore_const_arpa_many as rescore_many
    from kaldi_tpu_torch.lm.synth import synth_trigram_arpa
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.ops.pitch import compute_kaldi_pitch, process_pitch
    from kaldi_tpu_torch.ops.resample import resample_waveform
    from kaldi_tpu_torch.ops.signal import reverberate

    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    failed = []

    # (a) bench.py:452-481 at full width, then its audit (:483-544)
    t = time.perf_counter()
    vocab = [f"W{k:06d}" for k in range(1, BENCH_LM["vocab"] + 1)]
    lm3 = synth_trigram_arpa(vocab, n_bigrams=BENCH_LM["n_bigrams"],
                             n_trigrams=BENCH_LM["n_trigrams"],
                             rng=np.random.default_rng(BENCH_LM["seed"]))
    synth_s = time.perf_counter() - t
    n_ngrams = sum(len(d) for d in lm3.ngrams)
    if n_ngrams != BENCH_LM["ngrams"]:
        failed.append(f"the bench's trigram has {n_ngrams} n-grams, not "
                      f"{BENCH_LM['ngrams']}")
    t = time.perf_counter()
    clm = ConstArpaLm(lm3, symbol_table(vocab))
    build_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tabs = clm.device_tables("cuda")
    torch.cuda.synchronize()
    tab_s = time.perf_counter() - t
    lats, lats_u, refs = lt["lats"], lt["lats_u"], lt["refs"]
    lats_in = [lat for lat in lats if lat is not None]
    secs = lt["secs"]
    stats.update(lattices=0, levels=0, syncs=0, arcs=0, scalar=0)
    resc_c, resc_h, tc, th, diff = rescore_card_vs_cpu(lats_in, clm,
                                                       RESCORE_LM_SCALE)
    st = dict(stats)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_arcs = sum(lat.num_arcs for lat in resc_c)
    in_arcs = sum(lat.num_arcs for lat in lats_in)
    log(f"  (a) bench.py's trigram: {n_ngrams} n-grams over {len(vocab)} "
        f"words (synth_trigram_arpa, default_rng({BENCH_LM['seed']})) in "
        f"{synth_s:.3f} s; ConstArpaLm built in {build_s:.3f} s ("
        f"{clm.num_states} states, {len(clm.col_word)} entries); its "
        f"tables on the card {clm.table_bytes(tabs) / 1e6:.3f} MB, moved in "
        f"{tab_s:.3f} s | card: {card}")
    log(f"  (a) rescoring phase 14's {len(lats_in)} latgen lattices (of "
        f"{len(lats)}; None skipped, bench.py:475) at lm_scale "
        f"{RESCORE_LM_SCALE}: card {tc:.4f} s = "
        f"{len(lats_in) * secs / tc:.3f} audio-sec/s, CPU (the same code) "
        f"{th:.4f} s = {len(lats_in) * secs / th:.3f} audio-sec/s; "
        f"{st['levels'] // 2} BFS levels and {st['syncs'] // 2} host syncs "
        f"per device; {in_arcs} arcs in, {n_arcs} rescored arcs out; "
        f"lattices card == CPU: {len(resc_c) - diff}/{len(resc_c)}; "
        f"scalar fallbacks {st['scalar']}; peak device memory {peak:.3f} "
        f"GiB | card: {card}")
    if diff:
        failed.append(f"bench rescoring: {diff} lattices differ card vs CPU")
    if st["scalar"]:
        failed.append(f"{st['scalar']} decoder lattices were not "
                      f"topologically sorted")
    # the audit: truncated (rec_cap 3072) vs untruncated records
    t = time.perf_counter()
    n_ref = 0
    orc = [0.0, 0.0]
    hits = total = drift = used = 0
    both = [b for b, (x, y) in enumerate(zip(lats, lats_u))
            if x is not None and y is not None]
    resc_u = dict(zip(both, rescore_many([lats_u[b] for b in both], clm,
                                         RESCORE_LM_SCALE, device="cuda")))
    for b, (lt_, lu_, ref) in enumerate(zip(lats, lats_u, refs)):
        if b not in resc_u:
            continue
        used += 1
        n_ref += len(ref)
        orc[0] += _oracle_wer([ref], [lt_]) * len(ref) / 100.0
        orc[1] += _oracle_wer([ref], [lu_]) * len(ref) / 100.0
        seqs_u = {tuple(w for w in p[0] if w != 0)
                  for p in nbest(lu_, AUDIT_NBEST)}
        seqs_t = {tuple(w for w in p[0] if w != 0)
                  for p in nbest(lt_, max(AUDIT_NBEST * 4, 200))}
        total += len(seqs_u)
        hits += sum(s in seqs_t for s in seqs_u)
        rb = [lattice_best_path(x) for x in (
            resc_c[[i for i, x in enumerate(lats_in) if x is lt_][0]],
            resc_u[b])]
        drift += (list(rb[0][0]) if rb[0] else None) != \
            (list(rb[1][0]) if rb[1] else None)
    audit = dict(oracle_t=100.0 * orc[0] / max(n_ref, 1),
                 oracle_u=100.0 * orc[1] / max(n_ref, 1),
                 recall=100.0 * hits / max(total, 1), drift=drift, used=used)
    log(f"  (a) truncation audit over the {used} utterances with both "
        f"lattices (rec_cap 3072 vs untruncated, rec_beam = lattice beam 8 "
        f"in both): oracle WER truncated {audit['oracle_t']:.3f}%, "
        f"untruncated {audit['oracle_u']:.3f}%; top-{AUDIT_NBEST} path "
        f"recall {audit['recall']:.2f}%; rescored best-path drift "
        f"{drift} utterances; {time.perf_counter() - t:.3f} s")

    # (c) the feature modules on the bench's 8 test waves (10 s, 16 kHz)
    waves = lt["waves"]
    rir = seeded_rir(RIR["taps"], RIR["rt60"], RIR["seed"])
    ms = {}
    for dev in ("cuda", "cpu"):
        for what, fn in (
                ("pitch", lambda w: process_pitch(compute_kaldi_pitch(
                    w, device=dev))),
                ("reverberate", lambda w: reverberate(
                    w, rir, snr_db=RIR["snr_db"],
                    rng=np.random.RandomState(RIR["seed"]), device=dev)),
                ("resample", lambda w: resample_waveform(w, 16000.0, 8000.0,
                                                         device=dev))):
            fn(waves[0])
            if dev == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            for w in waves:
                fn(w)
            ms[what, dev] = 1e3 * (time.perf_counter() - t) / len(waves)
    t = time.perf_counter()
    f = features_card_vs_cpu(waves)
    log(f"  (c) features on the bench's {len(waves)} x 10 s test waves: ms "
        f"per utterance card / CPU: compute_kaldi_pitch + process_pitch "
        f"{ms['pitch', 'cuda']:.3f} / {ms['pitch', 'cpu']:.3f}, reverberate "
        f"({RIR['taps']}-tap RIR, {RIR['snr_db']} dB) "
        f"{ms['reverberate', 'cuda']:.3f} / {ms['reverberate', 'cpu']:.3f}, "
        f"resample_waveform 16 -> 8 kHz {ms['resample', 'cuda']:.3f} / "
        f"{ms['resample', 'cpu']:.3f} | card: {card}")
    log(f"  (c) card vs CPU, ratios to the bounds: convolution "
        f"{f['conv']:.3e}, resampling 16 -> 8 kHz {f['resample 8k']:.3e}, "
        f"16 -> 4 kHz {f['resample 4k']:.3e}, NCCF {f['nccf']:.3e}; Viterbi "
        f"frames differing on shared costs {f['viterbi frames']}; the whole "
        f"tracker's pitch differs on {f['pitch frames']} of {f['frames']} "
        f"frames (reported: the resampled input is rounded to f32 on each "
        f"device); process_pitch within {f['process_pitch']:.3e}; "
        f"{time.perf_counter() - t:.3f} s")
    bad = [k for k in ("conv", "resample 8k", "resample 4k", "nccf")
           if not f[k] <= 1.0] + (["viterbi frames"] if f["viterbi frames"]
                                  else [])
    if bad:
        failed.append(f"features at width card vs CPU: {bad} ({f})")
    if q.launches:
        failed.append(f"phase 30 (a, c) launched qaffine {q.launches} times")
    log(f"  launches: gather {tg.launches}, qaffine {q.launches}; phase 30 "
        f"(a, c) took {time.perf_counter() - t0:.3f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return dict(audit=audit, rescore=dict(card_s=tc, cpu_s=th,
                                          levels=st["levels"] // 2))


def phase_rescore_ladder(card: str, ld: dict) -> dict:
    """Phase 30 (b): rescoring, scoring, MBR, oracle, ctm, KWS and
    decode_biglm on the ladder's lattices."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.biglm import decode_biglm
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.kws import (TwvOptions, compute_twv,
                                     lattice_to_kws_index, search_index)
    from kaldi_tpu_torch.lat.align import word_align_lattice, words_to_ctm
    from kaldi_tpu_torch.lat.functions import (compose_lattice_with_lm,
                                               lattice_best_path)
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    from kaldi_tpu_torch.lat.mbr import mbr_decode
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm, stats
    from kaldi_tpu_torch.lm.const_arpa import \
        lattice_lmrescore_const_arpa_many as rescore_many
    from kaldi_tpu_torch.lm.synth import synth_trigram_arpa
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.steps import mono
    from kaldi_tpu_torch.steps.score import score_lattices

    q.launches = tg.launches = 0
    t0 = time.perf_counter()
    failed = []

    # (b) the ladder's lattices
    M = ld["models"]
    lang, lda, nnet = M["lang"], M["lda"], M["nnet"]
    refs_w = M["refs"]
    V = M["corpus"]["words"]
    tm = lda.model.trans_model
    g_old = arpa_to_g(ArpaLm.parse(M["arpa"]), lang.words)
    bo = lang.words["#0"]
    sil = frozenset({lang.phones["SIL"]})
    lex = {}
    for line in M["corpus"]["lex_text"].splitlines():
        w, *pron = line.split()
        lex.setdefault(lang.words[w], []).append(
            tuple(lang.phones[p] for p in pron))
    t = time.perf_counter()
    dec, graph_s = ladder_decoder(lda.model, M["arpa"], M["dopts"], "cuda")
    fb, nf = pad_batch([f for _u, f, _w in M["test_l"]])
    rungs = {}
    for name, am in (("lda_mllt", lda.model.am), ("tdnn", nnet.am)):
        ll = am.loglikes(fb)
        ll = ll.cpu().numpy() if hasattr(ll, "cpu") else np.asarray(ll)
        rungs[name] = dict(ll=ll, lats=decode_to_lattices(
            dec, ll, nf, lattice_beam=LATTICE_BEAM, num_threads=8))
    dec_s = time.perf_counter() - t
    uni = ConstArpaLm(ArpaLm.parse(M["arpa"]), lang.words)
    tri_lm = synth_trigram_arpa(V, LADDER_TRIGRAM["n_bigrams"],
                                LADDER_TRIGRAM["n_trigrams"],
                                rng=np.random.default_rng(
                                    LADDER_TRIGRAM["seed"]))
    tri = ConstArpaLm(tri_lm, lang.words)
    # the largest cost the unigram gives a word or </s>: what its f32
    # rounding in either LM scales
    c_max = max([abs(uni.step(uni.start_state(), lang.words[w])[1])
                 for w in V] + [abs(uni.final_cost(s))
                                for s in range(uni.num_states)])
    log(f"  (b) the ladder's 40 test utterances: HCLG {dec.graph.num_states} "
        f"states ({graph_s:.3f} s), lattices of the LDA+MLLT and TDNN rungs "
        f"(CsrBeamDecoder, beam 14, max_active 1024, lattice beam "
        f"{LATTICE_BEAM}) in {dec_s:.3f} s; trigram over the {len(V)} words: "
        f"{sum(len(d) for d in tri_lm.ngrams)} n-grams")
    def hyp_words(ids):
        return [lang.words.sym(x) for x in ids]
    out_b = {}
    for name, r in rungs.items():
        lats_r = r["lats"]
        live = [b for b, lat in enumerate(lats_r) if lat is not None]
        t = time.perf_counter()
        no_old = [topo_sorted(compose_lattice_with_lm(
            lats_r[b], g_old, bo, lm_scale=-1.0)) for b in live]
        t_compose = time.perf_counter() - t
        stats.update(scalar=0, levels=0)
        t = time.perf_counter()
        ident = rescore_many(no_old, uni, 1.0, device="cuda")
        resc_live = rescore_many(no_old, tri, 1.0, device="cuda")
        t_resc = time.perf_counter() - t
        levels = stats["levels"]
        resc = [None] * len(lats_r)
        for b, lat in zip(live, resc_live):
            resc[b] = lat
        ties = 0
        for b, new in zip(live, ident):
            old, got = lattice_best_path(lats_r[b]), lattice_best_path(new)
            bound = (len(old[0]) + 1) * 2.0 ** -23 * c_max \
                + 64 * F64_EPS * abs(old[2])
            gap = abs(got[2] - old[2])
            if list(got[0]) != list(old[0]):
                if gap <= bound:
                    ties += 1
                    log(f"  (b) {name} utt {b}: the identity rescoring's "
                        f"best path differs within the LMs' f32 rounding "
                        f"(gap {gap:.3e}, bound {bound:.3e})")
                else:
                    failed.append(f"{name} utt {b}: identity rescoring "
                                  f"moved the best path by {gap}")
            elif gap > bound:
                failed.append(f"{name} utt {b}: identity rescoring moved "
                              f"the cost by {gap} > {bound}")
        if stats["scalar"]:
            failed.append(f"{name}: {stats['scalar']} lattices took the "
                          f"scalar rescorer")
        w_best = wer(refs_w, [hyp_words(x) for x in _best_words(lats_r)])
        w_tri = wer(refs_w, [hyp_words(x) for x in _best_words(resc)])
        w_orc = _oracle_wer([[lang.words[w] for w in ref] for ref in refs_w],
                            lats_r)
        out_b[name] = dict(best=w_best, tri=w_tri, oracle=w_orc)
        n_arcs = sum(lats_r[b].num_arcs for b in live)
        log(f"  (b) {name}: {len(live)} lattices, {n_arcs} arcs; best path "
            f"{w_best:.2f}, oracle {w_orc:.2f}, trigram-rescored {w_tri:.2f} "
            f"(old G out by compose_lattice_with_lm on the host "
            f"{t_compose:.3f} s; the unigram back in and the trigram in on "
            f"the card {t_resc:.3f} s, {levels} BFS levels for the two; the "
            f"identity rescoring unchanged, {ties} near-ties) | card: {card}")
        if name == SWEEP_RUNG:
            t = time.perf_counter()
            best, (lmwt, wip), _grid = score_lattices(
                {b: lat for b, lat in enumerate(lats_r)},
                {b: ref for b, ref in enumerate(refs_w)}, words=lang.words,
                lm_scales=SWEEP_LMWT, word_ins_penalties=SWEEP_WIP)
            t_score = time.perf_counter() - t
            t = time.perf_counter()
            w_mbr = wer(refs_w, [hyp_words(mbr_decode(lat)[0])
                                 if lat is not None else [] for lat in lats_r])
            t_mbr = time.perf_counter() - t
            out_b[name].update(mbr=w_mbr, sweep=(lmwt, wip, best.wer))
            log(f"  (b) {name}: MBR {w_mbr:.2f} ({t_mbr:.3f} s); "
                f"score_lattices sweep (lmwt {SWEEP_LMWT}, wip "
                f"{SWEEP_WIP}) best lmwt "
                f"{lmwt}, wip {wip}: WER {best.wer:.2f} ({t_score:.3f} s) | "
                f"card: {card}")
        if not w_orc <= w_best:
            failed.append(f"{name}: oracle WER {w_orc} > best path {w_best}")
    # ctm and keyword search on the LDA+MLLT lattices
    lats_l = rungs["lda_mllt"]["lats"]
    # the ctm: word_align_lattice's best path where it aligns the lattice;
    # it emits a word only on the phones after its label, and the
    # decoder's word labels trail the word's first phone, so most come out
    # empty (JAX's host code, the same): then the raw best path
    t = time.perf_counter()
    ctm_hyp = aligned = 0
    for lat in lats_l:
        if lat is None:
            continue
        al = word_align_lattice(lat, tm, lex, sil)
        aligned += al.num_states > 0
        bp = lattice_best_path(al if al.num_states else lat)
        ctm_hyp += len(words_to_ctm(bp[1], [w for w in bp[0] if w], tm, lex,
                                    sil))
    t_ctm = time.perf_counter() - t
    batch, feats_l, nf_l = mono.compile_and_pad(
        lang, tm, lda.model.ctx_dep, M["test_l"], 1.0, 0.1)
    ali = viterbi_align(batch, lda.model.am.loglikes(feats_l), nf_l, 0.1,
                        device="cuda")
    ctms = {u: words_to_ctm(a[0], [lang.words[w] for w in ws], tm, lex, sil)
            for (u, _f, ws), a in zip(M["test_l"], ali) if a is not None}
    phrases = kws_phrases(refs_w, lang.words)
    t = time.perf_counter()
    utts = [u for u, _f, _w in M["test_l"]]
    index = [lattice_to_kws_index(lat, u) for lat, u in zip(lats_l, utts)
             if lat is not None]
    keywords = [(lang.words[w],) for w in V] + sorted(phrases)
    kw_hits = {kw: search_index(index, list(kw)) for kw in keywords}
    kws_s = time.perf_counter() - t
    kws_refs = _kws_refs(ctms, phrases)
    dur = float(np.sum(nf)) / 100.0
    twv = compute_twv(kws_refs, kw_hits, dur, TwvOptions())
    gap = max(kws_word_posterior_gap(lat, ix, sorted(set(ix.word.tolist())))
              for lat, ix in zip([x for x in lats_l if x is not None], index))
    log(f"  (b) ctm: word_align_lattice aligned {aligned} of "
        f"{sum(x is not None for x in lats_l)} LDA+MLLT lattices; "
        f"words_to_ctm over the best paths timed {ctm_hyp} words in "
        f"{t_ctm:.3f} s; "
        f"forced-alignment ctm of {len(ctms)} references; KWS: "
        f"{len(index)} indexes, {len(keywords)} keywords ({len(V)} words + "
        f"{len(phrases)} two-word phrases) searched in {kws_s:.3f} s; "
        f"ATWV {twv['atwv']:.4f}, STWV {twv['stwv']:.4f} at TwvOptions() "
        f"over {dur:.2f} s of audio; one-word posteriors vs forward-backward "
        f"within {gap:.3e} (limit 1e-9)")
    if not gap <= 1e-9:
        failed.append(f"KWS posterior off its forward-backward by {gap}")
    # decode_biglm: the padded decoder on the card, old G out, trigram in
    t = time.perf_counter()
    pdec = BeamSearchDecoder(dec.graph, BeamSearchOpts(
        beam=M["dopts"].beam, max_active=M["dopts"].max_active,
        acoustic_scale=0.1), device="cuda")
    big = decode_biglm(pdec, rungs["lda_mllt"]["ll"], nf, g_old, bo, tri,
                       lattice_beam=LATTICE_BEAM)
    big_s = time.perf_counter() - t
    w_big = wer(refs_w, [hyp_words(r[0]) if r else [] for r in big])
    log(f"  (b) decode_biglm (padded BeamSearchDecoder on the card, beam "
        f"{M['dopts'].beam}, max_active {M['dopts'].max_active}, lattice beam "
        f"{LATTICE_BEAM}) with the trigram over the 40 test utterances: WER "
        f"{w_big:.2f} in {big_s:.3f} s | card: {card}")
    launches = tg.launches
    if q.launches:
        failed.append(f"phase 30 launched qaffine {q.launches} times")
    log(f"  launches: gather {launches} (the ladder lattices' decodes), "
        f"qaffine {q.launches}; phase 30 (b) took "
        f"{time.perf_counter() - t0:.3f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return dict(launches=launches, ladder=out_b, atwv=twv["atwv"],
                biglm_wer=w_big)


# ---------------------------------------------------------------------------
# phases 31-32: the file layer and network serving

SERVE_BEAM = dict(beam=16.0, max_active=64, acoustic_scale=0.1)
SERVE_CHUNKINGS = {"even-4000": [4000], "odd-777": [777],
                   "byte-then-odd": [1, 3001]}
# phase 32 (e): the first SERVE_GMM_UTTS of the ladder's 40 test
# utterances (its first speaker's) through the online GMM decoder without
# adaptation, then again with the default adaptation policy (reported, not
# held): on an NVIDIA H100 80GB HBM3 (700 W) all 40 took 40.2 s without
# adaptation and 16 took 20.4 s with it, cut for the script's time limit
SERVE_GMM_UTTS = 8
SERVE_ADAPT_UTTS = 8
# phases 31 and 32's files, under build/ (gitignored): chiprun_out/ holds
# the witnesses and the logs
SERVE_DIR = os.path.join(ROOT, "build", "serving")


def yesno_gmm_system(seed: int = 3) -> dict:
    """A yesno monophone trained on the CPU (8 iterations, 40 gaussians,
    16 utterances of MFCC + deltas), its HCLG, and three test waves of 3,
    4 and 8 words (tests/test_torch_server.py's system)."""
    from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
    rng = np.random.RandomState(seed)
    utts = []
    for i in range(16):
        ws = [rng.choice(["YES", "NO"]) for _ in range(rng.randint(2, 5))]
        utts.append((f"u{i}", mfcc_deltas(yesno_synth(ws, rng), "cpu"), ws))
    lang, _ctx, _tm, _g = gmm_stack(YESNO_LEXICON, YESNO_ARPA)
    model = train_mono(lang, utts, MonoTrainOpts(
        num_iters=8, totgauss=40, max_iter_inc=6,
        realign_iters=tuple(range(1, 8))), device="cpu")
    packed = gmm_hclg(model.lang, YESNO_ARPA, model.trans_model,
                      model.ctx_dep)
    waves = [yesno_synth(ws, rng) for ws in
             (["YES", "NO", "YES"], ["NO", "NO", "YES", "NO"],
              ["YES", "NO", "YES", "NO", "YES", "NO", "YES", "NO"])]
    return dict(model=model, packed=packed, waves=waves)


def pcm_chunks(wave, pattern: list) -> list:
    """A wave as 16-bit PCM bytes cut by `pattern` (the last size repeats)."""
    pcm = np.clip(wave, -32768, 32767).astype("<i2").tobytes()
    out, pos, i = [], 0, 0
    while pos < len(pcm):
        n = pattern[min(i, len(pattern) - 1)]
        out.append(pcm[pos:pos + n])
        pos, i = pos + n, i + 1
    return out


def drive_session(session, chunks) -> list:
    """A session's hypothesis after every chunk, then its final one."""
    hyps = []
    for c in chunks:
        session.accept_pcm(c)
        hyps.append(session.hypothesis())
    session.finish()
    return hyps + [session.hypothesis(final=True)]


def gmm_session_factory(model, packed, device):
    """DecodeSessions of a GMM system (MFCC + deltas at 8 kHz, the padded
    decoder, 16-frame chunks) on `device`, as the CLI's online server
    builds them."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.online.decoder import OnlineDecoder
    from kaldi_tpu_torch.online.features import OnlineFeaturePipeline
    from kaldi_tpu_torch.online.server import DecodeSession
    base = BeamSearchDecoder(packed, BeamSearchOpts(**SERVE_BEAM),
                             device=device)
    fo = gmm_mfcc_opts()

    def session():
        return DecodeSession(
            lambda: OnlineFeaturePipeline(fo, delta_order=2, device=device),
            lambda: OnlineDecoder(base, chunk_frames=16),
            am=model.am, words=model.lang.words)
    return session


def gmm_mfcc_opts():
    from kaldi_tpu_torch.ops.features import MfccOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    return MfccOpts(frame_opts=FrameOpts(samp_freq=GMM_SR, dither=0.0))


def npz_same(a: str, b: str, loads=None) -> bool:
    """Two model files hold the same members and the same bytes in each
    array; a pickled host payload (`__host__`) is unpickled by `loads`
    (default: the port's) and compared by `host_equal`, since pickling
    the same sets again may order their elements otherwise."""
    from kaldi_tpu_torch.io.model_io import _loads
    loads = loads or _loads
    za, zb = np.load(a), np.load(b)
    if sorted(za.files) != sorted(zb.files):
        return False
    for k in za.files:
        x, y = za[k], zb[k]
        if k == "__host__":
            if not host_equal(loads(x.tobytes()), loads(y.tobytes())):
                return False
        elif not (x.dtype == y.dtype and x.shape == y.shape
                  and x.tobytes() == y.tobytes()):
            return False
    return True


def host_equal(a, b) -> bool:
    """Structural equality of unpickled host payloads: objects by class
    and attributes (`__slots__` or `__dict__`), arrays by dtype and
    value, containers element for element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(host_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(host_equal, a, b))
    if hasattr(a, "__slots__"):
        return all(host_equal(getattr(a, k), getattr(b, k))
                   for k in a.__slots__)
    if hasattr(a, "__dict__"):
        return host_equal(vars(a), vars(b))
    return a == b


def _state_equal(a, b) -> bool:
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    return list(sa) == list(sb) and all(
        torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)


def model_files_card_vs_cpu(ys: dict, out_dir: str,
                            card: str = "cuda") -> dict:
    """Every model kind of io/model_io.py through the port's save_* and
    load_*: each object is saved, loaded on `card` and on the CPU, and each
    load saved again. The files hold the same arrays bit for bit and equal
    host objects (`npz_same`), and each device object computes on the card
    exactly what it computed before the round trip. -> {kind: "ok"}."""
    import torch
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io import model_io as mio
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    from kaldi_tpu_torch.ivector.plda import Plda
    from kaldi_tpu_torch.lm.arpa import ArpaLm
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.nnet3.network import Nnet3
    from kaldi_tpu_torch.nnet3.training import AmNnet3
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    from kaldi_tpu_torch.steps.sgmm_steps import SgmmAm
    from kaldi_tpu_torch.tree import build_tree as tbt
    from kaldi_tpu_torch.tree.context_dep import TreeContextDependency

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(31)
    x39 = rng.randn(2, 30, 39).astype(np.float32)
    x8 = rng.randn(1, 12, 8).astype(np.float32)
    cfg = TdnnConfig(feat_dim=39, num_pdfs=ys["model"].am.num_pdfs,
                     hidden_dim=64, nonlinearity="relu",
                     splice_indexes=((-1, 0, 1), (-1, 2), (0,)))
    tdnn = Tdnn(cfg, device=card).load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(31)))
    net3 = Nnet3(nnet3_small_config("tdnn"), device=card)
    net3.init(torch.Generator().manual_seed(31))
    su = sgmm_small_setup(card)
    sam = SgmmAm(su["model"], 3)
    accs = Sgmm2Accs(su["model"])
    accs.accumulate(su["model"], su["feats"], su["post"], num_gselect=3)
    gacc = AccumAmDiagGmm(ys["model"].am)
    for a in gacc.accs:
        a.occ, a.mean_acc = rng.rand(*a.occ.shape), rng.randn(*a.mean_acc.shape)
    stats = tree_stats_example()
    questions = tbt.Questions(tbt.obtain_questions(stats), num_pdf_classes=3)
    tree, n = tbt.build_tree(stats, questions, [[p] for p in range(1, 9)],
                             {p: 3 for p in range(1, 9)}, None, [True] * 8,
                             max_leaves=12, thresh=5.0, cluster_thresh=-1.0)
    A = rng.randn(3, 4, 4)
    arpa = ("\\data\\\nngram 1=4\nngram 2=2\n\n\\1-grams:\n-1.0\t<s>\t-0.3\n"
            "-0.7\ta\t-0.2\n-0.9\tb\n-0.8\t</s>\n\n\\2-grams:\n-0.3\t<s> a\n"
            "-0.4\ta b\n\n\\end\\\n")
    ubm = DiagGmm(rng.dirichlet(np.ones(4)), rng.randn(4, 5),
                  rng.uniform(0.5, 2.0, (4, 5)))
    ext = IvectorExtractor(ubm, 3, seed=1)
    objs = {
        "gmm_system": (gmm_model_on(ys["model"], card),
                       lambda m: m.am.loglikes(x39)),
        "hclg": (ys["packed"], None),
        "am_nnet": (AmNnet(tdnn, np.full(cfg.num_pdfs, 1.0 / cfg.num_pdfs)),
                    lambda m: m.loglikes(x39)),
        "raw_nnet": (tdnn, lambda m: m(torch.as_tensor(x39, device=card))),
        "am_nnet3": (AmNnet3(net3), lambda m: m.loglikes(x8)),
        "ivector_extractor": (ext, None),
        "const_arpa": (ConstArpaLm(ArpaLm.parse(arpa),
                                   symbol_table(["a", "b", "<s>", "</s>"])),
                       None),
        "ubm": (FullGmm(rng.dirichlet(np.ones(3)), rng.randn(3, 4),
                        A @ A.transpose(0, 2, 1) + np.eye(4)), None),
        "plda": (Plda(mean=rng.randn(4), transform=rng.randn(4, 4),
                      psi=rng.rand(4)), None),
        "gmm_accs": (gacc, None),
        "tree_stats": ((stats, 3, 1), None),
        "tree": (TreeContextDependency(3, 1, tree, n), None),
        "sgmm2": (sam, lambda m: m.loglikes(su["feats"][None, :40])),
        "sgmm2_accs": (accs, lambda m: m.Y),
    }
    ondev = {"gmm_system", "am_nnet", "raw_nnet", "am_nnet3", "sgmm2",
             "sgmm2_accs"}
    out = {}
    for kind, (obj, compute) in objs.items():
        save = getattr(mio, f"save_{kind}")
        load = getattr(mio, f"load_{kind}")
        a, b = (os.path.join(out_dir, f"{kind}.{k}") for k in ("a", "b"))
        _save_kind(save, a, obj)
        kw = [dict(device=card), dict(device="cpu")] if kind in ondev \
            else [{}, {}]
        on_card, on_cpu = load(a, **kw[0]), load(a, **kw[1])
        _save_kind(save, b, on_card)
        if not npz_same(a, b):
            raise AssertionError(f"model file {kind}: the card's load saves "
                                 f"other data")
        c = os.path.join(out_dir, f"{kind}.c")
        _save_kind(save, c, on_cpu)
        if not npz_same(a, c):
            raise AssertionError(f"model file {kind}: the CPU's load saves "
                                 f"other data")
        if compute is not None:
            m = on_card[0] if kind == "raw_nnet" else on_card
            with torch.no_grad():
                got, want = compute(m), compute(obj)
            if not torch.equal(torch.as_tensor(got).cpu(),
                               torch.as_tensor(want).cpu()):
                raise AssertionError(f"model file {kind}: the card's load "
                                     f"computes otherwise")
        out[kind] = "ok"
    return out


def _save_kind(save, path: str, obj):
    """save_<kind> of an object as its load_<kind> returns it (tree
    stats, raw nnets and GMM accs load as tuples of save's arguments)."""
    if isinstance(obj, tuple):
        save(path, *obj)
    else:
        save(path, obj)


def tree_stats_example(seed: int = 7, dim: int = 5) -> dict:
    """tests/test_torch_tree.py's seeded tree statistics (the port's
    classes)."""
    from kaldi_tpu_torch.tree import clustering as tcl
    from kaldi_tpu_torch.tree.event_map import KPDF_CLASS
    rng = np.random.RandomState(seed)
    stats = {}
    for _ in range(160):
        left, right = (int(v) for v in rng.randint(0, 9, 2))
        centre = int(rng.randint(1, 9))
        if centre == 8:
            left = right = 0
        for pc in range(3):
            ev = frozenset([(KPDF_CLASS, pc), (0, left), (1, centre),
                            (2, right)])
            n = int(rng.randint(5, 30))
            mean = (np.full(dim, 2.0 * (centre % 3) + pc) + 0.7 * (left % 2))
            x = mean + rng.randn(n, dim) * 0.5
            st = stats.get(ev)
            new = tcl.GaussStats(count=float(n), x=x.sum(0),
                                 x2=(x * x).sum(0))
            stats[ev] = new if st is None else st.add(new)
    return stats


def ark_round_trips(out_dir: str) -> dict:
    """Binary, text and compressed arks by the port: written, read by the
    native reader (by path) and the Python reader (by handle) alike, the
    native writer's bytes equal to the Python writer's. -> counts."""
    from kaldi_tpu_torch.io import kaldi_io, native
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(32)
    items = [(f"u{i}", rng.randn(rng.randint(5, 300), 40).astype(np.float32))
             for i in range(6)]
    checked = 0
    for mode, kw in (("binary", {}), ("text", dict(binary=False)),
                     ("compressed", dict(compress=True))):
        path = os.path.join(out_dir, f"{mode}.ark")
        kaldi_io.write_ark(path, items, **kw)
        by_path = list(kaldi_io.read_ark(path))
        with open(path, "rb") as f:
            by_handle = list(kaldi_io.read_ark(f))
        if [k for k, _v in by_path] != [k for k, _v in items] or any(
                not np.array_equal(a, b) for (_k, a), (_k2, b)
                in zip(by_path, by_handle)):
            raise AssertionError(f"{mode} ark: the readers disagree")
        if mode == "binary" and any(not np.array_equal(a, b) for (_k, a),
                                    (_k2, b) in zip(by_path, items)):
            raise AssertionError("binary ark: not bit-exact")
        if mode == "binary":
            nat = list(native.read_ark_native(path))
            if any(not np.array_equal(a, b) for (_k, a), (_k2, b)
                   in zip(nat, items)):
                raise AssertionError("native reader != the written arrays")
        checked += len(items)
    npath = os.path.join(out_dir, "native.ark")
    with native.ArkWriterNative(npath) as w:
        for k, v in items:
            w.write(k, v)
    with open(npath, "rb") as f, open(os.path.join(out_dir, "binary.ark"),
                                      "rb") as g:
        if f.read() != g.read():
            raise AssertionError("native writer's bytes != Python writer's")
    return dict(entries=checked, native=native.available())


def sessions_card_vs_cpu(ys: dict, card: str = "cuda") -> dict:
    """DecodeSession (the yesno GMM) and FusedDecodeSession (the small
    stream setup through `fused_session_factory`) fed the same bytes in
    fixed and odd-length chunks on `card` and on the CPU: every partial
    and the final hypothesis equal. -> {session: number of hypotheses}."""
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.server import fused_session_factory
    su = small_stream_setup()
    am = AmNnet(Tdnn(su["cfg"]).load_jax_params(su["params"]),
                priors=su["priors"])
    rng = np.random.default_rng(33)
    fwave = (rng.standard_normal(20000) * 4000).astype(np.float32)
    out = {}
    for name, wave, make in (
            ("gmm", ys["waves"][1], lambda dev: gmm_session_factory(
                gmm_model_on(ys["model"], dev), ys["packed"], dev)),
            ("fused", fwave, lambda dev: fused_session_factory(
                am, su["graph"], su["opts"], su["fb"],
                symbol_table([f"w{k}" for k in range(1, 41)]), device=dev,
                chunk_samples=2560, t_max=256))):
        n = 0
        for label, pattern in SERVE_CHUNKINGS.items():
            chunks = pcm_chunks(wave, pattern)
            got = drive_session(make(card)(), chunks)
            want = drive_session(make("cpu")(), chunks)
            if got != want:
                raise AssertionError(f"{name} session ({label}): card "
                                     f"{got[-1]!r} != CPU {want[-1]!r}")
            if not got[-1] or len(set(got)) < 3:
                raise AssertionError(f"{name} session: no partials")
            n += len(got)
        out[name] = n
    return out


def threaded_vs_sync(ys: dict, card: str = "cuda") -> int:
    """ThreadedSingleUtteranceDecoder over a seeded TDNN on the yesno
    HCLG equals the synchronous SingleUtteranceNnet2Decoder (words, tids,
    cost within 1e-4) on `card`. -> words decoded."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.online.features import (OnlineFeaturePipeline,
                                                 OnlineProcessedFeature)
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.params import random_tdnn_params
    m = ys["model"]
    cfg = TdnnConfig(feat_dim=39, num_pdfs=m.am.num_pdfs, hidden_dim=32,
                     nonlinearity="relu", splice_indexes=((-1, 0, 1), (0,)))
    am = AmNnet(Tdnn(cfg).load_jax_params(random_tdnn_params(
        cfg, np.random.default_rng(7))),
        np.random.default_rng(8).dirichlet(np.ones(cfg.num_pdfs)))
    dec = BeamSearchDecoder(ys["packed"], BeamSearchOpts(**SERVE_BEAM),
                            device=card)

    def make():
        return SingleUtteranceNnet2Decoder(
            am, m.trans_model, dec, OnlineNnet2FeaturePipeline(
                OnlineProcessedFeature(OnlineFeaturePipeline(
                    gmm_mfcc_opts(), delta_order=2, device=card))),
            chunk_frames=16)
    n = 0
    for wave in ys["waves"]:
        want = _sync_decode(make(), wave, 1600)
        got = _threaded_decode(make(), wave, 1600)
        _same_results("threaded decoder", [got], [want], card)
        n += len(want[0])
    return n


def _sync_decode(sud, wave, step: int):
    for lo in range(0, len(wave), step):
        sud.pipeline.accept_waveform(wave[lo: lo + step])
        sud.advance_decoding()
    sud.finalize_decoding()
    return sud.best_path()


def _threaded_decode(sud, wave, step: int):
    from kaldi_tpu_torch.online.threaded import \
        ThreadedSingleUtteranceDecoder
    t = ThreadedSingleUtteranceDecoder(sud)
    for lo in range(0, len(wave), step):
        t.accept_waveform(wave[lo: lo + step])
    t.input_finished()
    if not t.wait(timeout=300.0):
        raise AssertionError("threaded decoder: timeout")
    return t.best_path()


def run_gmm_decoder(model, beam_decoder, wave, policy):
    """SingleUtteranceGmmDecoder over `model` fed 250 ms per call -> (best
    path, transform or None after each call, the re-estimations'
    (features, partial path, start, transform))."""
    from kaldi_tpu_torch.online.features import OnlineFeaturePipeline
    from kaldi_tpu_torch.online.gmm_decoding import SingleUtteranceGmmDecoder
    sud = SingleUtteranceGmmDecoder(
        model.am, model.trans_model, beam_decoder,
        OnlineFeaturePipeline(gmm_mfcc_opts(), delta_order=2,
                              device=beam_decoder.device),
        policy=policy, fmllr_min_count=20.0)
    transforms, calls = [], []
    estimate = sud.estimate_fmllr

    def recorded(raw):
        init = sud.state.transform
        res = sud.decoder.best_path(use_final_probs=False)
        estimate(raw)
        calls.append((np.array(raw), res, init, sud.state.transform))
    sud.estimate_fmllr = recorded
    step = int(0.25 * GMM_SR)
    for lo in range(0, len(wave), step):
        sud.pipeline.accept_waveform(wave[lo: lo + step])
        sud.advance_decoding()
        transforms.append(None if sud.state.transform is None
                          else np.array(sud.state.transform))
    sud.finalize_decoding()
    return sud.best_path(), transforms, calls


def fmllr_replay(am_a, am_b, tm, raw, res) -> dict:
    """One online re-estimation's fMLLR statistics from two AMs (the same
    GMM on two devices) on the same features and partial path, the term
    scale and the bound that the two AMs' gaussian posteriors' difference
    sets on them (`fmllr_term_scale`): -> {"K", "G": (max |a - b| /
    bound, max bound / scale)}."""
    from kaldi_tpu_torch.transform.fmllr import FmllrStats, _posteriors_np
    tids = res[1]
    T = min(len(tids), raw.shape[0])
    x = raw[:T]
    pdfs = np.array([tm.transition_id_to_pdf(t) for t in tids[:T]])
    st = []
    for am in (am_a, am_b):
        s = FmllrStats(x.shape[1])
        s.accumulate_from_alignment(am, x, pdfs)
        st.append(s)
    post = [_posteriors_np(am, x.astype(np.float32), pdfs,
                           np.ones(T, np.float32)) for am in (am_a, am_b)]
    bound = fmllr_term_scale(am_a, x, pdfs, post=np.abs(post[0] - post[1]))
    scale = fmllr_term_scale(am_a, x, pdfs)
    out = {}
    for k in ("K", "G"):
        b = getattr(bound, k) + 1e-9 * getattr(scale, k)
        out[k] = (float(np.max(np.abs(getattr(st[0], k) - getattr(st[1], k))
                               / b)),
                  float(np.max(getattr(bound, k)
                               / np.maximum(getattr(scale, k), 1e-30))))
    return out


def gmm_decoder_card_vs_cpu(ys: dict, card: str = "cuda") -> dict:
    """SingleUtteranceGmmDecoder on the yesno system's 8-word wave with
    early adaptation (first estimate at 0.5 s) on `card` and on the CPU:
    the same words and tids, re-estimations at the same calls, and each
    of the card's re-estimations replayed against the CPU's AM on the
    card's inputs: its statistics within the bound that the two AMs'
    posteriors' difference sets. -> {"words", "estimates", "bound ratio",
    "bound share", "max |dW| / max |W|"} (the last reported only: the
    solve amplifies the statistics' last digits)."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.online.gmm_decoding import AdaptationPolicy
    policy = AdaptationPolicy(adaptation_first_utt_delay=0.5,
                              adaptation_first_utt_ratio=1.5)
    wave = ys["waves"][2]
    runs = {}
    for dev in (card, "cpu"):
        m = gmm_model_on(ys["model"], dev)
        dec = BeamSearchDecoder(ys["packed"], BeamSearchOpts(**SERVE_BEAM),
                                device=dev)
        runs[dev] = (m,) + run_gmm_decoder(m, dec, wave, policy)
    (ma, ra, ta, ca), (mb, rb, tb, cb) = runs[card], runs["cpu"]
    if list(ra[0]) != list(rb[0]) or list(ra[1]) != list(rb[1]):
        raise AssertionError("online GMM decoder: card != CPU words")
    if [t is None for t in ta] != [t is None for t in tb] or not ca:
        raise AssertionError("online GMM decoder: adaptation schedules "
                             "differ")
    ratio, share = 0.0, 0.0
    for raw, res, _init, _W in ca:
        r = fmllr_replay(ma.am, mb.am, ma.trans_model, raw, res)
        ratio = max(ratio, r["K"][0], r["G"][0])
        share = max(share, r["K"][1], r["G"][1])
    dW = max(float(np.abs(a - b).max() / np.abs(b).max())
             for a, b in zip(ta, tb) if a is not None)
    return {"words": len(ra[0]), "estimates": len(ca), "bound ratio": ratio,
            "bound share": share, "max |dW| / max |W|": dW}


def codec_checks() -> dict:
    """µ-law and IMA ADPCM: chunked encode and decode with carried state
    equal the one-shot codes and samples bit for bit; the round trip's
    SNR on a tone. -> {"mulaw snr", "adpcm snr"}."""
    from kaldi_tpu_torch.online import compress
    t = np.arange(8000) / GMM_SR
    x = (9000 * np.sin(2 * np.pi * 440 * t)
         + np.random.RandomState(34).randn(8000) * 300).astype(np.float32)
    one, _ = compress.adpcm_encode(x)
    es, ds, codes, dec = compress.AdpcmState(), compress.AdpcmState(), [], []
    for lo in range(0, len(x), 777):
        c, es = compress.adpcm_encode(x[lo:lo + 777], es)
        d, ds = compress.adpcm_decode(c, ds)
        codes.append(c)
        dec.append(d)
    if not np.array_equal(np.concatenate(codes), one) or not np.array_equal(
            np.concatenate(dec), compress.adpcm_decode(one)[0]):
        raise AssertionError("ADPCM: chunked != one-shot")
    mu = compress.mulaw_encode(x)
    if not np.array_equal(np.concatenate([compress.mulaw_encode(x[:3001]),
                                          compress.mulaw_encode(x[3001:])]),
                          mu):
        raise AssertionError("µ-law: chunked != one-shot")

    def snr(y):
        return float(10 * np.log10((x ** 2).mean() / ((x - y) ** 2).mean()))
    return {"mulaw snr": snr(compress.mulaw_decode(mu)),
            "adpcm snr": snr(np.concatenate(dec))}


def phase_serving_small() -> None:
    """Phase 31: the file layer and the serving classes, small, card vs
    CPU."""
    t0 = time.perf_counter()
    ys = yesno_gmm_system()
    log(f"  yesno system: {ys['model'].am.num_pdfs} pdfs, "
        f"{ys['model'].am.total_gauss} gaussians (trained on the CPU in "
        f"{time.perf_counter() - t0:.3f} s)")
    t = time.perf_counter()
    kinds = model_files_card_vs_cpu(ys, os.path.join(SERVE_DIR, "small"))
    log(f"  model files: {len(kinds)} kinds ({', '.join(kinds)}) saved, "
        f"loaded on the card and on the CPU and saved again: the same "
        f"array bytes and host objects, the card's loads compute exactly "
        f"what the originals did ({time.perf_counter() - t:.3f} s)")
    a = ark_round_trips(os.path.join(SERVE_DIR, "arks"))
    log(f"  arks: {a['entries']} entries binary, text and compressed; the "
        f"native reader (built: {a['native']}) and the Python reader agree, "
        f"the native writer's bytes are the Python writer's")
    s = sessions_card_vs_cpu(ys)
    log(f"  DecodeSession (yesno GMM) and FusedDecodeSession (small CSR) fed "
        f"{len(SERVE_CHUNKINGS)} chunkings (even, odd, one byte first): "
        f"every partial and final equal on the card and the CPU ({s})")
    n = threaded_vs_sync(ys)
    log(f"  ThreadedSingleUtteranceDecoder == synchronous decoder on the "
        f"card ({n} words over 3 utterances)")
    g = gmm_decoder_card_vs_cpu(ys)
    if not g["bound ratio"] <= 1.0:
        raise AssertionError(f"online GMM decoder: fMLLR statistics outside "
                             f"their bound ({g})")
    log(f"  SingleUtteranceGmmDecoder (first estimate at 0.5 s): card == CPU "
        f"words ({g['words']}), {g['estimates']} re-estimations at the same "
        f"calls; statistics within {g['bound ratio']:.3e} of the "
        f"posterior bound (bound {g['bound share']:.3e} of the terms); "
        f"transforms differ by {g['max |dW| / max |W|']:.3e} of max |W| "
        f"(reported)")
    c = codec_checks()
    log(f"  codecs: µ-law and ADPCM chunked == one-shot bit for bit; SNR "
        f"µ-law {c['mulaw snr']:.2f} dB, ADPCM {c['adpcm snr']:.2f} dB; "
        f"phase 31 took {time.perf_counter() - t0:.3f} s")


def _serve_concurrently(server, waves, chunk_samples: int) -> list:
    """Stream each wave on its own connection, all at once (one client
    thread each) -> [(lines, timings)]."""
    import threading
    from kaldi_tpu_torch.online.server import stream_wave
    server.serve_in_background()
    out = [None] * len(waves)
    errors = []

    def client(i):
        try:
            tm = {}
            out[i] = (stream_wave("127.0.0.1", server.port, waves[i],
                                  chunk_samples=chunk_samples, timings=tm),
                      tm)
        except Exception as e:               # noqa: BLE001 — raised below
            errors.append(e)
    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(waves))]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 2 * SOCKET_TIMEOUT_S
        for t in threads:
            t.join(timeout=max(deadline - time.perf_counter(), 0.0))
    finally:
        server.shutdown()
    if errors or any(o is None for o in out):
        raise AssertionError(f"clients failed: {errors}")
    return out


def _finals(results) -> list:
    for lines, _tm in results:
        if not lines or not lines[-1].startswith("FINAL"):
            raise AssertionError(f"no FINAL line: {lines[-3:]}")
    return [lines[-1][len("FINAL"):].split() for lines, _tm in results]


def phase_serving_full(tg, card: str, on: dict, ld: dict) -> dict:
    """Phase 32: phase 16's configuration behind the TCP server, and the
    ladder's tri system behind the online GMM decoder and the CLI."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.io import model_io as mio
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.online import compress
    from kaldi_tpu_torch.online.features import OnlineFeaturePipeline
    from kaldi_tpu_torch.online.gmm_decoding import AdaptationPolicy
    from kaldi_tpu_torch.online.server import (AudioServer,
                                               fused_session_factory)

    t0 = time.perf_counter()
    out_dir = os.path.join(SERVE_DIR, "full")
    os.makedirs(out_dir, exist_ok=True)
    SR, chunk = 16000.0, 2560
    # (a) the AM and HCLG through the port's files, loaded on the card
    am_p, g_p = os.path.join(out_dir, "am.mdl"), os.path.join(out_dir, "HCLG")
    mio.save_am_nnet(am_p, on["am"])
    mio.save_hclg(g_p, on["graph"])
    am = mio.load_am_nnet(am_p, device="cuda")
    graph = mio.load_hclg(g_p)
    if not _state_equal(am.model, on["am"].model) or not np.array_equal(
            am.priors, on["am"].priors) or any(
            not np.array_equal(getattr(graph, k), getattr(on["graph"], k))
            for k in ("arc_start", "ilabel", "olabel", "cost", "nextstate",
                      "pdf", "final")):
        raise AssertionError("phase 16's AM or HCLG changed through the "
                             "port's files")
    log(f"  (a) phase 16's AM ({os.path.getsize(am_p)} bytes) and HCLG "
        f"({os.path.getsize(g_p)} bytes) saved by the port and loaded on "
        f"the card: bit-equal")

    # (b) 6 concurrent connections at phase 16's configuration
    vocab = int(graph.olabel.max())
    words = symbol_table([f"w{k}" for k in range(1, vocab + 1)])
    waves = on["test_waves"]
    want = [[f"w{w}" for w in r[0]] for r in on["offline"]]
    factory = fused_session_factory(am, graph, on["csr_opts"], on["fb"],
                                    words, device="cuda",
                                    chunk_samples=chunk, t_max=1024)
    factory()                              # warm-up: one session's set-up
    q.launches = tg.launches = 0           # count the server's path only
    t = time.perf_counter()
    res = _serve_concurrently(AudioServer("127.0.0.1", 0, factory), waves,
                              chunk)
    wall = time.perf_counter() - t
    launches, q_launches = tg.launches, q.launches
    got = _finals(res)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"server FINALs differ from phase 16's offline "
                             f"decode at connections {bad}")
    if not launches or q_launches:
        raise AssertionError(f"server path: gather {launches} launches, "
                             f"qaffine {q_launches}")
    audio = sum(len(w) for w in waves) / SR
    fin = [(tm["final"] - tm["shut_wr"]) * 1e3 for _l, tm in res]
    conn = [tm["final"] - tm["start"] for _l, tm in res]
    partials = [sum(ln.startswith("PARTIAL") for ln in lines)
                for lines, _tm in res]
    span = max(tm["final"] for _l, tm in res) - min(tm["start"]
                                                   for _l, tm in res)
    p50, p95 = _pcts(fin)
    frames = len(waves) * on["frames"]
    log(f"  (b) AudioServer, {len(waves)} concurrent connections of "
        f"{audio / len(waves):.2f} s each, {chunk} samples per send: every "
        f"FINAL == phase 16's offline CSR decode; per-connection wall "
        f"{min(conn):.3f}-{max(conn):.3f} s; FINAL latency after SHUT_WR "
        f"p50 {p50:.3f} ms p95 {p95:.3f} ms; partials per connection "
        f"{partials}; aggregate {audio / span:.3f} audio-sec/s ({audio:.2f} "
        f"s of audio in {span:.3f} s, {wall:.3f} s with the server's start "
        f"and stop); gather launches {launches} "
        f"({launches / frames:.2f} per frame), qaffine {q_launches} | card: "
        f"{card}")
    shapes = csr_gather_shapes(factory().fused.dec, 1, on["am"].num_pdfs)
    times = gather_at_shapes(tg, shapes, "the server's", 5)

    # (c) the same streams through µ-law and ADPCM transport
    wers = {}
    for codec in ("mulaw", "adpcm"):
        if codec == "mulaw":
            cw = [compress.mulaw_decode(compress.mulaw_encode(w))
                  for w in waves]
        else:
            cw = [compress.adpcm_decode(compress.adpcm_encode(w)[0])[0]
                  for w in waves]
        t = time.perf_counter()
        cres = _finals(_serve_concurrently(
            AudioServer("127.0.0.1", 0, factory), cw, chunk))
        wers[codec] = wer(got, cres)
        log(f"  (c) {codec} transport: WER {wers[codec]:.2f} against the "
            f"uncompressed FINALs ({time.perf_counter() - t:.3f} s)")

    # (d) the threaded decoder over phase 16's generic path
    t = time.perf_counter()
    for u, sync in enumerate(on["generic"]):
        thr = _threaded_decode(on["make_generic"](), waves[u], chunk)
        _same_results("threaded generic path", [thr], [sync], "cuda")
    log(f"  (d) ThreadedSingleUtteranceDecoder over phase 16's generic path, "
        f"{len(on['generic'])} utterances: == the synchronous decoder "
        f"(words, tids) ({time.perf_counter() - t:.3f} s)")

    # (e) the online GMM decoder over phase 20's tri
    m = ld["models"]
    tri, lang = m["tri"], m["lang"]
    packed = ladder_packed(tri, m["arpa"])
    bopts = BeamSearchOpts(beam=LADDER_DECODE["beam"],
                           max_active=LADDER_DECODE["max_active"],
                           acoustic_scale=0.1)
    bdec = BeamSearchDecoder(packed, bopts, device="cuda")
    test = m["corpus"]["test"][:SERVE_GMM_UTTS]
    refs = [ws for _u, _w, ws, _s in test]
    never = AdaptationPolicy(adaptation_first_utt_delay=1e9,
                             adaptation_delay=1e9)
    t = time.perf_counter()
    plain = [run_gmm_decoder(tri, bdec, w, never)[0]
             for _u, w, _ws, _s in test]
    t_plain = time.perf_counter() - t
    feats, fdiff = [], 0.0
    ladder_f = {u: f for u, f, _ws in m["test"]}
    for u, w, _ws, _s in test:
        pipe = OnlineFeaturePipeline(gmm_mfcc_opts(), delta_order=2,
                                     device="cuda")
        pipe.accept_waveform(w)
        pipe.input_finished()
        feats.append(pipe.get_features())
        n = min(len(feats[-1]), len(ladder_f[u]))
        fdiff = max(fdiff, float(np.abs(feats[-1][:n]
                                        - ladder_f[u][:n]).max()))
    fb, nf = pad_batch(feats)
    offline = bdec.decode(tri.am.loglikes(fb), nf)
    # chunked and batched GEMMs round the loglikes differently: the same
    # words and tids, the cost (a sum over frames) within 1e-4
    _same_decodes("online GMM decoder (no adaptation)", plain, offline)
    t = time.perf_counter()
    adapted = [run_gmm_decoder(tri, bdec, w, AdaptationPolicy())
               for _u, w, _ws, _s in test[:SERVE_ADAPT_UTTS]]
    t_ad = time.perf_counter() - t
    n_est = sum(len(c) for _r, _t, c in adapted)
    sym = lang.words.sym
    w_plain = wer(refs, [[sym(x) for x in r[0]] for r in plain])
    w_plain_a = wer(refs[:SERVE_ADAPT_UTTS],
                    [[sym(x) for x in r[0]] for r in plain[:SERVE_ADAPT_UTTS]])
    w_ad = wer(refs[:SERVE_ADAPT_UTTS],
               [[sym(x) for x in r[0]] if r else []
                for r, _t, _c in adapted])
    log(f"  (e) SingleUtteranceGmmDecoder over phase 20's tri "
        f"({tri.am.num_pdfs} pdfs), the first {len(test)} of the ladder's "
        f"{len(m['corpus']['test'])} test utterances, 250 ms per "
        f"call: without adaptation == the offline decode of the same "
        f"pipeline's features, WER {w_plain:.2f} ({t_plain:.3f} s); the "
        f"default AdaptationPolicy on the first {len(adapted)}: {n_est} fMLLR "
        f"estimates, WER {w_ad:.2f} against {w_plain_a:.2f} unadapted "
        f"({t_ad:.3f} s); phase 20 tri {ld['tri']['wer']:.2f} on all 40 "
        f"from the ladder's batch features, which the online "
        f"pipeline does not reproduce: its per-utterance MFCC and deltas "
        f"differ from the zero-padded batch's by up to {fdiff:.3e} (the "
        f"deltas of the last frames read past the utterance's end there)")

    # (f) the CLI in-process
    t = time.perf_counter()
    cli_out = serving_cli(tri, packed, lang, test[:2], plain[:2], out_dir)
    log(f"  (f) CLI: online-server-gmm-decode-faster (tri and its HCLG as "
        f"the port saved them, 2 connections) and online-audio-client: "
        f"FINALs == (e)'s; online2-wav-nnet2-am-compute: {cli_out['rows']} "
        f"rows read back by read_ark == AmNnet.loglikes_np on the same "
        f"features ({time.perf_counter() - t:.3f} s); phase 32 took "
        f"{time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "shape": shapes[0],
            "times": times[shapes[0]], "fin_p50": p50, "fin_p95": p95,
            "audio_s_per_s": audio / span, "wers": wers}


def ladder_packed(model, arpa: str):
    """`model`'s HCLG over the ARPA LM by the flat pipeline, packed."""
    from kaldi_tpu_torch.fst.mkgraph_flat import make_hclg_flat, pack_graph_flat
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    g = arpa_to_g(ArpaLm.parse(arpa), model.lang.words)
    hclg, _st = make_hclg_flat(model.lang, g, model.trans_model,
                               model.ctx_dep, self_loop_scale=0.1)
    return pack_graph_flat(hclg, model.trans_model.id2pdf_array)


def serving_cli(tri, packed, lang, test, want, out_dir: str) -> dict:
    """Phase 32 (f): the CLI's online server over `tri` and `packed` as the
    port saves them, two connections, the client on two utterances (each
    FINAL == `want`'s words); then online2-wav-nnet2-am-compute over a
    seeded TDNN of phase 16's width on the MFCC + deltas, read back by
    read_ark and held equal to AmNnet.loglikes_np on the same features."""
    import contextlib
    import io
    import threading
    from kaldi_tpu_torch import cli
    from kaldi_tpu_torch.io import kaldi_io, model_io as mio
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.online.features import (OnlineFeaturePipeline,
                                                 OnlineProcessedFeature)
    from kaldi_tpu_torch.params import random_tdnn_params
    mdl, hclg = (os.path.join(out_dir, n) for n in ("tri.mdl", "tri.HCLG"))
    mio.save_gmm_system(mdl, tri)
    mio.save_hclg(hclg, packed)
    scp = os.path.join(out_dir, "wav.scp")
    with open(scp, "w") as f:
        for u, w, _ws, _s in test:
            path = os.path.join(out_dir, f"{u}.wav")
            write_wave(path, w, GMM_SR)
            f.write(f"{u} {path}\n")
    pf = os.path.join(out_dir, "port")
    if os.path.exists(pf):
        os.remove(pf)
    srv = threading.Thread(target=cli.main, args=([
        "online-server-gmm-decode-faster", mdl, hclg, "--port-file", pf,
        "--num-connections", "2", "--sample-frequency", str(GMM_SR),
        "--beam", str(LADDER_DECODE["beam"]), "--max-active",
        str(LADDER_DECODE["max_active"]), "--device", "cuda"],), daemon=True)
    srv.start()
    for _ in range(1200):
        if os.path.exists(pf) and open(pf).read():
            break
        time.sleep(0.05)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["online-audio-client", "127.0.0.1", open(pf).read(), scp])
    srv.join(timeout=120)
    lines = buf.getvalue().splitlines()
    for (u, _w, _ws, _s), line, r in zip(test, lines, want):
        if line.split() != [u, "FINAL"] + [lang.words.sym(x) for x in r[0]]:
            raise AssertionError(f"CLI server: {line!r} != {r[0]}")
    if len(lines) != len(test):
        raise AssertionError(f"CLI client printed {lines}")
    cfg = TdnnConfig(feat_dim=39, num_pdfs=tri.am.num_pdfs, hidden_dim=512,
                     nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    am = AmNnet(Tdnn(cfg, device="cuda").load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(35))),
        np.full(cfg.num_pdfs, 1.0 / cfg.num_pdfs))
    nnet = os.path.join(out_dir, "tdnn.mdl")
    mio.save_am_nnet(nnet, am)
    ark = os.path.join(out_dir, "am.ark")
    cli.main(["online2-wav-nnet2-am-compute", nnet, scp, f"ark:{ark}",
              "--sample-frequency", str(GMM_SR), "--device", "cuda"])
    rows = dict(kaldi_io.read_ark(ark))
    for u, _w, _ws, _s in test:
        wave = read_wave(os.path.join(out_dir, f"{u}.wav"))[0][0]
        pipe = OnlineProcessedFeature(OnlineFeaturePipeline(
            gmm_mfcc_opts(), delta_order=2, device="cuda"))
        step = int(0.5 * GMM_SR)
        for lo in range(0, len(wave), step):
            pipe.accept_waveform(wave[lo:lo + step])
        pipe.input_finished()
        x = pipe.get_frames(0, pipe.num_frames_ready())[None]
        if not np.array_equal(rows[u], am.loglikes_np(x)[0]):
            raise AssertionError(f"am-compute row {u} != loglikes_np")
    return {"rows": sum(len(v) for v in rows.values())}


# ------------------------- decoder tools, graph helpers, recipe witnesses

TOOLS_GRAPH = dict(vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1)
TOOLS_TINY = dict(vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3)
TOOLS_CSR = dict(beam=11.0, max_active=256, acoustic_scale=0.1,
                 expand_budget=4096, eps_budget=1024, hub_threshold=64)
TOOLS_LENGTHS = [30, 64, 50, 70, 90, 100, 120]
BENCH_SEARCH = dict(beam=13.0, max_active=7000, acoustic_scale=0.1,
                    expand_budget=16384, eps_budget=2048)   # bench.py:235-238
BATCHED_CUTS_S = (3.0, 6.0)     # phase 34 (b): each test wave cut here too
BATCHED_SIZE = 8
SELF_BUILT = dict(vocab=2000, n_bigrams=20000, n_trigrams=10000)
SELF_BUILT_FRAMES = 100
BIG_BITS = int(np.array(1e10, np.float32).view(np.int32))
LVTLN_WITNESS = os.path.join(ROOT, "chiprun_out", "lvtln_witness.pkl")
SAT_WITNESS = os.path.join(ROOT, "chiprun_out", "sat_witness.pkl")
CSR_WITNESS = os.path.join(ROOT, "chiprun_out", "csr_witness.pkl")
DBN_WITNESS = os.path.join(ROOT, "chiprun_out", "dbn_witness.pkl")
# the hidden units whose updated W rows the DBN witness keeps: the CD-1
# update needs all of W before, its check a sample of W after
DBN_WITNESS_ROWS = 256
SMBR_WITNESS = os.path.join(ROOT, "chiprun_out", "smbr_witness.pkl")


def tier_table_corruptions(tabs) -> list:
    """(field, row, col, change, message) for the corruptions of
    tests/test_csr_beam.py:383-430 and :736 (a live tier-A arc's
    nextstate, pdf, olabel and cost; a tier-B row; the quad layout's
    packed tid) and a live padding arc of a partly filled tier-B row; each
    must make `check_tier_tables` raise with `message`."""
    srow = np.asarray(tabs.srow.cpu()) if hasattr(tabs.srow, "cpu") \
        else np.asarray(tabs.srow)
    live = np.flatnonzero(srow[:, 0] != BIG_BITS)
    out = [("srow", live[0], 1, 1, "tier-A"), ("srow", live[0], 2, 1, "pdf"),
           ("srow", live[0], 4, 1, "olabel"), ("srow", live[0], 0, 1, "cost"),
           ("brow", 0, 1, 1, "tier-B rows")]
    apr = tabs.b_apr
    if apr == 4:
        out.append(("brow", 0, 2, 1 << 16, "tier-B rows"))
    deg = srow[:, 11]
    s = np.flatnonzero((deg > 2) & (deg % apr != 0))[0]
    i = int(deg[s])
    out.append(("brow", int(srow[s, 10]) + i // apr,
                (4 if apr == 4 else 5) * (i % apr), -1, "padding arc"))
    return out


def corrupt_tables(tabs, field, row, col, change, wrap=None):
    """A copy of the tier tables with one entry of `field` changed (+1, a
    flipped packed-tid bit, or a padding arc made live), wrapped by `wrap`
    (default: a torch tensor on the field's device)."""
    import torch
    t = getattr(tabs, field)
    a = (t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)).copy()
    a[row, col] = (a[row, col] ^ change if change == 1 << 16
                   else 7 if change == -1 else a[row, col] + change)
    new = wrap(a) if wrap else torch.from_numpy(a).to(t.device)
    return dataclasses.replace(tabs, **{field: new})


def verify_card_vs_cpu(card="cuda") -> dict:
    """`check_packed_graph` and `check_tier_tables` on the card's and the
    CPU's tables of tests/test_csr_beam.py's word-loop graph, in the quad
    and the triple tier-B layout: silent on both, and every corruption of
    `tier_table_corruptions` raises with the same message on each."""
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.verify import (check_packed_graph,
                                                check_tier_tables)
    g, _ = make_big_hclg(BigGraphConfig(**TOOLS_GRAPH))
    check_packed_graph(g, num_pdfs=TOOLS_GRAPH["num_pdfs"])
    n = 0
    for triple in (False, True):
        opts = CsrBeamOpts(max_active=64, expand_budget=256, hub_threshold=64,
                           force_b_triple=triple)
        decs = [CsrBeamDecoder(g, opts, device=d) for d in (card, "cpu")]
        for dec in decs:
            check_tier_tables(dec.graph, dec.tabs, 64)
        for case in tier_table_corruptions(decs[1].tabs):
            msgs = []
            for dec in decs:
                try:
                    check_tier_tables(dec.graph,
                                      corrupt_tables(dec.tabs, *case[:4]), 64)
                    msgs.append(None)
                except ValueError as e:
                    msgs.append(str(e))
            if msgs[0] is None or msgs[0] != msgs[1] or case[4] not in \
                    msgs[0]:
                raise AssertionError(f"corruption {case} (triple {triple}): "
                                     f"{msgs}")
            n += 1
    return {"corruptions": n}


class RecordingDecoder:
    """A decoder that passes `decode` on and keeps each batch's loglikes
    and overflow: the per-utterance comparison decodes the same rows."""

    def __init__(self, dec):
        self.dec, self.lls, self.overflow = dec, [], []

    def decode(self, ll, nf):
        res = self.dec.decode(ll, nf)
        self.lls.append(ll)
        self.overflow.append(int(np.asarray(self.dec.last_overflow).sum()))
        return res


def batched_vs_single(dec, utts, score_fn, batch_size, device) -> dict:
    """`decode_batched` over `dec` against the decode of each utterance
    alone (B = 1, its batch's loglikes rows cut to its length, the same
    decoder): words and tids equal, cost within 1e-4. -> the results, the
    seconds between CUDA events (or the host clock on the CPU), the
    overflow per batch, the padding share and the batch shapes."""
    import torch
    from kaldi_tpu_torch.decoder.batching import bucket_batches, decode_batched
    from kaldi_tpu_torch.ops import table_gather as tg
    rd = RecordingDecoder(dec)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
    t, n0 = time.perf_counter(), tg.launches
    got = decode_batched(rd, utts, score_fn, batch_size=batch_size,
                         device=device)
    if cuda:
        ev[1].record()
        torch.cuda.synchronize()
        secs = ev[0].elapsed_time(ev[1]) / 1e3
    else:
        secs = time.perf_counter() - t
    launches = tg.launches - n0
    batches = bucket_batches(utts, batch_size)
    if len(batches) != len(rd.lls):
        raise AssertionError(f"{len(rd.lls)} batches, expected "
                             f"{len(batches)}")
    worst, shapes = 0.0, []
    for (bound, members), ll in zip(batches, rd.lls):
        shapes.append((len(members), bound))
        for b, (k, f) in enumerate(members):
            n = f.shape[0]
            one = dec.decode(ll[b:b + 1, :n], np.array([n], np.int32))[0]
            if got[k] is None or one is None or \
                    list(got[k][0]) != list(one[0]) or \
                    list(got[k][1]) != list(one[1]) or \
                    abs(got[k][2] - one[2]) > 1e-4:
                raise AssertionError(
                    f"{k}: batched {None if got[k] is None else got[k][0]} "
                    f"!= alone {None if one is None else one[0]}")
            worst = max(worst, abs(got[k][2] - one[2]))
    frames = sum(f.shape[0] for _k, f in utts)
    padded = sum(batch_size * bound for bound, _m in batches)
    return {"res": got, "secs": secs, "overflow": rd.overflow,
            "launches": launches,
            "pad_share": 1.0 - frames / padded, "shapes": shapes,
            "cost_gap": worst, "frames": frames}


def tools_utts() -> list:
    """Seeded 8-dim features of TOOLS_LENGTHS frames, keyed u0, u1, ..."""
    rng = np.random.RandomState(5)
    return [(f"u{i}", rng.randn(n, 8).astype(np.float32))
            for i, n in enumerate(TOOLS_LENGTHS)]


def tools_score(x):
    """A frame-wise seeded stand-in for the AM over TOOLS_GRAPH's pdfs,
    [B, T, 8] -> [B, T, 64] on the batch's device (numpy in, numpy out)."""
    import torch
    w = np.random.RandomState(6).randn(8, TOOLS_GRAPH["num_pdfs"]).astype(
        np.float32)
    if torch.is_tensor(x):
        return (x @ torch.from_numpy(w).to(x.device)) * 2.0
    return np.asarray(x, np.float32) @ w * 2.0


def batched_card_vs_cpu(card="cuda") -> dict:
    """decode_batched over CsrBeamDecoder on the card and on the CPU, each
    equal to its per-utterance decodes, and the two equal (words, tids,
    cost within 1e-4)."""
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    g, _ = make_big_hclg(BigGraphConfig(**TOOLS_GRAPH))
    utts = tools_utts()
    out = [batched_vs_single(CsrBeamDecoder(g, CsrBeamOpts(**TOOLS_CSR),
                                            device=d),
                             utts, tools_score, 2, d)
           for d in (card, "cpu")]
    a, b = out[0]["res"], out[1]["res"]
    for k, _f in utts:
        if list(a[k][0]) != list(b[k][0]) or list(a[k][1]) != list(b[k][1]) \
                or abs(a[k][2] - b[k][2]) > 1e-4:
            raise AssertionError(f"{k}: card {a[k][0]} != CPU {b[k][0]}")
    return {"utts": len(utts), "batches": out[0]["shapes"],
            "pad_share": out[0]["pad_share"], "launches": out[0]["launches"]}


def simple_vs_csr(card="cuda", seed=0) -> dict:
    """`simple_decode` (the oracle) against the CSR decoder on `card` at a
    beam and frontier wide enough that neither prunes: the same words,
    cost within 1e-4."""
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.simple import simple_decode
    g, _ = make_big_hclg(BigGraphConfig(**TOOLS_TINY))
    ll = (np.random.RandomState(seed).randn(24, TOOLS_TINY["num_pdfs"])
          * 3).astype(np.float32)
    want = simple_decode(g, ll)
    wide = CsrBeamOpts(beam=1e9, max_active=g.num_states,
                       acoustic_scale=0.1, expand_budget=1 << 16,
                       eps_budget=1 << 14, hub_threshold=1 << 20)
    got = CsrBeamDecoder(g, wide, device=card).decode(
        ll[None], np.array([24], np.int32))[0]
    if list(got[0]) != want[0] or abs(got[2] - want[2]) > 1e-4:
        raise AssertionError(f"simple {want[0]} {want[2]} != CSR {got[0]} "
                             f"{got[2]}")
    return {"words": len(want[0]), "cost_gap": abs(got[2] - want[2])}


def phase_tools_small() -> None:
    """Phase 33: the decoder tools and recipe utilities, small, card vs
    CPU."""
    import tempfile
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.utils.profiling import AccuProfiler, device_trace
    q.launches = 0
    t = time.perf_counter()
    v = verify_card_vs_cpu()
    log(f"  check_packed_graph / check_tier_tables: silent on the card's "
        f"and the CPU's tables (quad and triple tier-B layouts, a hub), "
        f"{v['corruptions']} corruptions raise alike on both")
    b = batched_card_vs_cpu()
    if b["launches"] == 0:
        raise AssertionError("decode_batched on the card launched no gather")
    log(f"  decode_batched over CsrBeamDecoder: {b['utts']} utterances in "
        f"batches {b['batches']} (padding {b['pad_share']:.3f}) == the "
        f"per-utterance decodes, card == CPU; gather launches "
        f"{b['launches']} in decode_batched")
    s = [simple_vs_csr(seed=k) for k in (0, 1)]
    log(f"  simple_decode == CsrBeamDecoder on the card at an unpruned "
        f"beam: words and cost (gaps {[x['cost_gap'] for x in s]})")
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    g, _ = make_big_hclg(BigGraphConfig(**TOOLS_GRAPH))
    dec = CsrBeamDecoder(g, CsrBeamOpts(**TOOLS_CSR), device="cuda")
    ll = torch.randn(2, 20, 64, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        with device_trace(d):
            dec.decode(ll, np.array([20, 12], np.int32))
        trace = open(os.path.join(d, "trace.json")).read()
    if "table_gather_kernel" not in trace:
        raise AssertionError("device_trace: no table_gather_kernel in it")
    prof = AccuProfiler()
    with prof.track("sleep"):
        torch.cuda._sleep(int(2e8))
    if prof.seconds["sleep"] < 0.02:
        raise AssertionError(f"AccuProfiler measured {prof.seconds['sleep']}"
                             f" s around a card sleep: no synchronize")
    if q.launches:
        raise AssertionError(f"qaffine launched {q.launches} times")
    log(f"  device_trace: {len(trace)} bytes naming table_gather_kernel; "
        f"AccuProfiler around a card sleep {prof.seconds['sleep']:.4f} s "
        f"(synchronised); qaffine launches 0; phase 33 "
        f"{time.perf_counter() - t:.3f} s")


def phase_tools_full(tg, sl: dict, tr: dict, card: str) -> dict:
    """Phase 34: (a) the verifiers over the bench graph's tier tables on
    the card, (b) decode_batched with phase 13's AM over the bench's test
    utterances and their cuts, (c) the self-built triphone graph at the
    full tree width, card vs CPU."""
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.verify import (check_packed_graph,
                                                check_tier_tables)
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops.features import cmvn, fbank
    from kaldi_tpu_torch.recognize import SERVING_FBANK
    from kaldi_tpu_torch.scripts.mkgraph_scale import build
    q.launches = 0
    graph, dec = sl["graph"], sl["decoder"]
    if any(getattr(dec.opts, k) != v for k, v in BENCH_SEARCH.items()):
        raise AssertionError("phase 7's decoder is not at bench.py's options")
    # (a)
    t = time.perf_counter()
    check_packed_graph(graph, num_pdfs=2048)
    check_packed_graph(dec.graph, num_pdfs=2048)
    t_packed = time.perf_counter() - t
    t = time.perf_counter()
    check_tier_tables(dec.graph, dec.tabs, dec.opts.hub_threshold)
    t_tier = time.perf_counter() - t
    log(f"  (a) check_packed_graph over the bench graph ({graph.num_states} "
        f"states, {graph.num_arcs} arcs) and its eps-folded copy "
        f"{t_packed:.3f} s; check_tier_tables over the card's tier tables "
        f"({dec.tabs.srow.shape[0]} states, tier-B {dec.tabs.b_apr} "
        f"arcs/row, {len(dec.tabs.hub_bounds) - 1} hub(s)) {t_tier:.3f} s; "
        f"both silent")
    # (b)
    tdnn = tr["tdnn"]
    waves = np.asarray(tr["waves"][TRAIN_UTTS:])
    refs = tr["ref"][TRAIN_UTTS:]
    groups = {"10s": waves}
    for c in BATCHED_CUTS_S:
        groups[f"{c:g}s"] = waves[:, : int(c * 16000)]
    utts = []
    for name, w in groups.items():
        x = cmvn(fbank(torch.as_tensor(w, device="cuda"), SERVING_FBANK))
        utts += [(f"{i}-{name}", x[i].cpu().numpy()) for i in range(len(w))]

    def score(x):
        return tdnn(x, pad_context=True, compute_dtype=torch.bfloat16)
    with torch.inference_mode():
        bt = batched_vs_single(dec, utts, score, BATCHED_SIZE, "cuda")
    launches = bt["launches"]
    if sum(bt["overflow"]):
        raise AssertionError(f"decode_batched overflow {bt['overflow']}")
    if len(bt["shapes"]) < 3 or launches == 0:
        raise AssertionError(f"{len(bt['shapes'])} batches, {launches} "
                             f"gather launches")
    # Recognizer's words (each group as one batch, its edge frames
    # replicated), for information: word errors of the batched decode
    # against them
    rec_w, bat_w = [], []
    with torch.inference_mode():
        for name, w in groups.items():
            x = cmvn(fbank(torch.as_tensor(w, device="cuda"), SERVING_FBANK))
            ll = score(x)
            res = dec.decode(ll, np.full(len(w), ll.shape[1], np.int32))
            rec_w += [list(r[0]) if r else [] for r in res]
            bat_w += [list(bt["res"][f"{i}-{name}"][0])
                      for i in range(len(w))]
    n_words = sum(len(x) for x in rec_w)
    diff = round(wer(rec_w, bat_w) * n_words / 100.0)
    w10 = wer(refs, [list(bt["res"][f"{i}-10s"][0])
                     for i in range(len(waves))])
    audio = bt["frames"] / 100.0
    log(f"  (b) decode_batched at bench.py's options over {len(utts)} "
        f"utterances (the {len(waves)} test waves whole and cut at "
        f"{BATCHED_CUTS_S} s), batch_size {BATCHED_SIZE}: batches (B, T) "
        f"{bt['shapes']}, padding share {bt['pad_share']:.4f}; "
        f"{audio / bt['secs']:.3f} audio-sec/s between CUDA events "
        f"({bt['secs']:.3f} s, fbank+CMVN outside); gather launches "
        f"{launches}; overflow {bt['overflow']}; == each utterance decoded "
        f"alone (B = 1, the same loglikes rows): words and tids, cost gap "
        f"{bt['cost_gap']:.2e}; WER of the whole waves {w10:.2f}%; word "
        f"errors against Recognizer's words (edge frames replicated, not "
        f"the bucket's zero padding): {diff} of {n_words} | card: {card}")
    # (c)
    t = time.perf_counter()
    packed, num_pdfs, stats = build(**SELF_BUILT)
    build_s = time.perf_counter() - t
    check_packed_graph(packed, num_pdfs=num_pdfs)
    decs = {d: CsrBeamDecoder(packed, CsrBeamOpts(**BENCH_SEARCH), device=d)
            for d in ("cuda", "cpu")}
    t = time.perf_counter()
    check_tier_tables(decs["cuda"].graph, decs["cuda"].tabs,
                      decs["cuda"].opts.hub_threshold)
    t_tier_c = time.perf_counter() - t
    ll = (np.random.default_rng(1).standard_normal(
        (2, SELF_BUILT_FRAMES, num_pdfs)) * 3).astype(np.float32)
    nf = np.full(2, SELF_BUILT_FRAMES, np.int32)
    tg.launches = 0
    res = {d: dec.decode(ll, nf) for d, dec in decs.items()}
    launches_c = tg.launches
    if launches_c == 0:
        raise AssertionError("the self-built graph's card decode launched "
                             "no gather")
    ovf = int(np.asarray(decs["cuda"].last_overflow).sum())
    for b in range(2):
        a, c = res["cuda"][b], res["cpu"][b]
        if a is None or c is None or list(a[0]) != list(c[0]) or \
                list(a[1]) != list(c[1]):
            raise AssertionError(f"self-built graph, utterance {b}: card "
                                 f"!= CPU")
    if q.launches:
        raise AssertionError(f"qaffine launched {q.launches} times")
    log(f"  (c) self-built triphone graph (the port's mkgraph_scale.build, "
        f"{SELF_BUILT}, default_rng(0)): {stats['states']} states, "
        f"{stats['arcs']} arcs, {num_pdfs} pdfs, {stats['num_tids']} "
        f"transition ids; built in {build_s:.1f} s; check_packed_graph and "
        f"check_tier_tables ({t_tier_c:.3f} s) silent; 2 utterances of "
        f"seeded loglikes ({nf.tolist()} frames) card == CPU (words and "
        f"tids), overflow {ovf}, gather launches {launches_c} | card: "
        f"{card}")
    return {"launches": launches, "graph_launches": launches_c,
            "tier_s": t_tier, "rate": audio / bt["secs"],
            "pad_share": bt["pad_share"], "rec_words": rec_w[:len(waves)]}


# the CLI's first and second slices (phases 35-37): every device
# subcommand and the first slice's host ones once on the card (the default
# device) and once with --device cpu, the bench decode driven through
# files, and the GMM recipe through files at the ladder's width

CLI_FEAT_TOL = dict(rtol=2e-4, atol=2e-3)   # tests/test_torch_features.py
CLI_EXACT_TOL = dict(rtol=1e-6, atol=1e-6)  # test_torch_online_features.py
CLI_SLIDING_TOL = dict(rtol=2e-5, atol=2e-5)    # its sliding-CMVN cases
CLI_NNET_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_torch_am_nnet.py
CLI_PITCH_REL = 1e-6         # of each column's scale (test_torch_pitch_signal)
CLI_ACC_REL = 1e-5           # GMM accumulators: of each array's largest value
CLI_LL_REL = 1e-5            # GMM loglikes: of their GEMM terms (phases 17-20)
CLI_EIGH_REL = 1e-9          # a full-covariance update's eigenvalue floor
CLI_LAT_ATOL = 1e-4          # lattice costs (tests/test_torch_lattice.py)
# averaged posteriors (nnet-adjust-priors): |exp a - exp b| <= p |a - b| to
# first order, and the forward's CLI_NNET_TOL gives |a - b| <= 1e-5 (1 +
# |a|); p |log p| <= 1/e, so each prior moves at most 1e-5 (1 + 1/e),
# rounded up to cover the second order and the sums
CLI_PRIORS_BOUND = 1.4e-5
PRINTED_ATOL = 1.5e-4        # 4 printed decimals plus the forward's bound
CLI_SHRINK_REL = 1e-4        # tests/test_torch_surgery.py's shrink bound
LAT_TEXT_REL = 1e-5          # two writes of a lattice cost at 6 digits
CLI_SR = "8000"
# the fifth slice's (5a) device commands (tests/test_torch_cli_sre.py):
# extractor statistics from gselect posteriors within 1e-6 (of each
# array's largest value); a UBM's EM through splits; a whole extractor
# run and its i-vectors; logistic regression's weights step for step
CLI_POST_REL = 1e-5
CLI_UBM_REL = 1e-3
CLI_EM_REL = 1e-5
CLI_LR_REL = 1e-5
# the yesno decodes of the third slice's device cases: a tiny graph's search
CLI_LATGEN = ["--beam", "14", "--max-active", "64", "--lattice-beam", "7"]
YESNO_BIGRAM = ("\\data\\\nngram 1=4\nngram 2=4\n\n\\1-grams:\n-0.5\t</s>\n"
                "-99\t<s>\t-0.3\n-0.4\tNO\t-0.2\n-0.4\tYES\t-0.2\n\n"
                "\\2-grams:\n-0.2\t<s> NO\n-0.3\tNO YES\n-0.2\tYES NO\n"
                "-0.5\tYES </s>\n\n\\end\\\n")


def cli_call(argv) -> tuple[str, int, float, str]:
    """The port's CLI in-process -> (stdout, exit code, seconds, stderr)."""
    import contextlib
    import io
    from kaldi_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else (
                0 if e.code is None else 1)
    return out.getvalue(), rc, time.perf_counter() - t, err.getvalue()


def cli_inputs(d: str):
    """Seeded inputs for every host and device subcommand of the slice:
    yesno waves at 8 kHz (one stereo) in a wav.scp, an RIR, segments,
    MFCC-like features, (nccf, pitch) rows, VAD decisions, CMVN
    statistics, transforms, vectors, weights, alignments, matrices and
    data-dir text files. -> P(name) -> path."""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.io.wave import write_wave
    os.makedirs(d, exist_ok=True)

    def P(*n):
        return os.path.join(d, *n)
    rng = np.random.RandomState(17)
    scp = []
    for i, ws in enumerate((["YES", "NO"], ["NO", "YES", "YES"],
                            ["YES", "NO", "NO"])):
        w = yesno_synth(ws, rng)
        if i == 2:
            w = np.stack([w, 0.5 * w[::-1]])
        write_wave(P(f"u{i}.wav"), w, GMM_SR)
        scp.append(f"u{i} {P(f'u{i}.wav')}\n")
    with open(P("wav.scp"), "w") as f:
        f.writelines(scp)
    rir = np.exp(-np.arange(400) / 60.0) * rng.randn(400)
    rir[0] = 1.0
    write_wave(P("rir.wav"), (rir * 3000).astype(np.float32), GMM_SR)
    feats = {f"u{i}": (rng.randn(T, 13) * 3 + rng.randn(13) * 5)
             .astype(np.float32) for i, T in enumerate((57, 83, 40))}
    write_ark(P("feats.ark"), feats, scp_path=P("feats.scp"))
    write_ark(P("short.ark"), {k: v[:-1] for k, v in feats.items()})
    pitch = {k: np.stack([rng.uniform(-0.2, 1.0, T),
                          120 + 30 * np.sin(np.arange(T) / 7.0)
                          + rng.randn(T)], 1).astype(np.float32)
             for k, T in (("u0", 60), ("u1", 45))}
    write_ark(P("pitch.ark"), pitch)
    write_ark(P("vad.ark"), {k: (v[:, 0] > np.median(v[:, 0]))
                             .astype(np.float32) for k, v in feats.items()})
    stats = {}
    for k, v in feats.items():
        x = v.astype(np.float64)
        st = np.zeros((2, 14))
        st[0, :13], st[0, 13], st[1, :13] = x.sum(0), len(x), (x * x).sum(0)
        stats[k] = st
    write_ark(P("cmvn.ark"), stats)
    W = rng.randn(10, 14)
    write_ark(P("affine.ark"), {"t": W.astype(np.float32)})
    write_ark(P("linear.ark"), {"t": W[:, :13].astype(np.float32)})
    write_ark(P("B_aff.ark"), {"t": rng.randn(6, 7).astype(np.float32)})
    write_ark(P("A.ark"), {"t": rng.randn(4, 7).astype(np.float32)})
    write_ark(P("vt.ark"), {"t": rng.randn(2, 3).astype(np.float32)})
    write_ark(P("vecs.ark"), {k: rng.randn(3).astype(np.float32)
                              for k in ("u0", "u1")})
    write_ark(P("w1.ark"), {"a": rng.uniform(0, 1, 5).astype(np.float32)})
    write_ark(P("w2.ark"), {"a": rng.uniform(0, 1, 5).astype(np.float32)})
    write_ark(P("ali.ark"), {k: rng.randint(0, 13, len(v)).astype(np.int32)
                             for k, v in feats.items()})
    for name, text in (
            ("segments", "s0 u0 0.10 0.50\ns1 u1 0.25 0.90\n"),
            ("fsegments", "s0 u0 0.03 0.15\ns1 u1 0.10 0.33\n"),
            ("ranges", "r0 u0 2 9\nr1 u1 0 30\n"),
            ("ivv.txt", "a 1 2 ; 3\nb 4 ;\n"),
            ("utt2spk", "u0 A\nu1 B\nu2 A\n"), ("spk2utt", "A u0 u2\nB u1\n"),
            ("reco2file_and_channel", "u0 c1 A\nu1 c1 B\nu2 c2 A\n"),
            ("ref", "u0 a b c\nu1 d e\n"), ("hyp", "u0 a x c\nu1 d e f\n")):
        with open(P(name), "w") as f:
            f.write(text)
    cli_gmm_inputs(lambda *n: P("gmm", *n), rng)
    cli_nnet_inputs(lambda *n: P("nnet", *n), lambda *n: P("gmm", *n))
    cli_sre_inputs(lambda *n: P("sre", *n))
    cli_adapt_inputs(lambda *n: P("adapt", *n), lambda *n: P("gmm", *n))
    return P


def sre_cli_corpus(P) -> tuple[dict, dict]:
    """4 synthetic speakers x 4 utterances of 60 frames x 5 dims (two
    content clusters at +-3 plus a constant per-speaker offset,
    RandomState(11)) written under P(name): f.ark, f1.ark (the first 8),
    utt2spk, spk2utt, trials (speaker x utterance), pairs (utterance x
    utterance) and ivm.ark (12 x 6 matrices). -> (feats, utt2spk)."""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    rng = np.random.RandomState(11)
    offs = [np.full(5, v) for v in (0.8, -0.8, 0.4, -0.4)]
    feats, utt2spk = {}, {}
    for i in range(16):
        s = i % 4
        content = np.where(rng.rand(60, 1) < 0.5, 3.0, -3.0)
        u = f"s{s}-u{i // 4}"
        feats[u] = (rng.randn(60, 5) + content + offs[s]).astype(np.float32)
        utt2spk[u] = f"s{s}"
    feats = dict(sorted(feats.items()))
    keys = list(feats)
    write_ark(P("f.ark"), feats)
    write_ark(P("f1.ark"), {k: feats[k] for k in keys[:8]})
    with open(P("utt2spk"), "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in sorted(utt2spk.items()))
    with open(P("spk2utt"), "w") as f:
        for s in sorted(set(utt2spk.values())):
            f.write(s + " " + " ".join(u for u in keys if utt2spk[u] == s)
                    + "\n")
    with open(P("trials"), "w") as f:
        f.writelines(f"s{s} {u}\n" for s in range(4) for u in keys)
    with open(P("pairs"), "w") as f:
        f.writelines(f"{a} {b}\n" for a in keys[:4] for b in keys)
    write_ark(P("ivm.ark"), {u: rng.randn(12, 6).astype(np.float32)
                             for u in keys[:3]})
    return feats, utt2spk


def cli_sre_inputs(S) -> None:
    """The fifth slice's speaker inputs under S(name), through the port's
    CLI on the CPU: `sre_cli_corpus`, a full UBM of 4 gaussians, an
    extractor of dimension 6 and its statistics, and i-vectors."""
    os.makedirs(S(), exist_ok=True)
    sre_cli_corpus(S)
    F, cpu = f"ark:{S('f.ark')}", ["--device", "cpu"]
    for argv in (
            ["train-ubm", F, S("fubm.npz"), "--num-gauss", "4",
             "--num-iters", "3", "--full", *cpu],
            ["ivector-extractor-init", S("fubm.npz"), S("ext0.npz"),
             "--ivector-dim", "6"],
            ["ivector-extractor-acc-stats", S("ext0.npz"), F, S("acc.npz"),
             *cpu],
            ["ivector-extractor-est", S("ext0.npz"), S("acc.npz"),
             S("ext1.npz"), *cpu],
            ["ivector-extract", S("ext1.npz"), F, f"ark:{S('iv.ark')}",
             *cpu]):
        _cli_ok(argv[0], cli_call(argv))


def online_feature_bounds(wav_scp: str, sr: float,
                          num_ceps: int = 13) -> dict:
    """{utt: [T, 3 num_ceps] bound} for online2-wav-dump-features'
    MFCC + deltas of two computations that differ in their FFT: each MFCC
    element's `fft_feature_bound`, and for the delta and delta-delta
    columns the window maximum of that bound (2 and 4 frames on either
    side) times the filters' sum of |coefficients| (0.6 and 0.36)."""
    from kaldi_tpu_torch import ops
    from kaldi_tpu_torch.io.wave import read_wave
    fo = ops.MfccOpts(frame_opts=ops.FrameOpts(samp_freq=sr, dither=0.0),
                      num_ceps=num_ceps)
    out = {}
    with open(wav_scp) as f:
        scp = [ln.split() for ln in f if ln.strip()]
    for utt, path in scp:
        b = fft_feature_bound(read_wave(path)[0][0], fo, "mfcc")
        cols = []
        for gain, w in ((1.0, 0), (0.6, 2), (0.36, 4)):
            pad = np.pad(b, ((w, w), (0, 0)), mode="edge")
            cols.append(gain * np.max([pad[i:i + len(b)]
                                       for i in range(2 * w + 1)], axis=0))
        out[utt] = np.concatenate(cols, axis=1)
    return out


def cli_gmm_inputs(G, rng) -> None:
    """The second and third slices' device commands' inputs under
    G(name): 8 yesno utterances of MFCC + deltas, a monophone trained on
    them, its alignments, posteriors (plain and signed), loglikes, tree
    statistics, a 20-leaf tree, a full-covariance UBM and its statistics,
    its HCLG, G as a text FST, a bigram's const-ARPA, its raw lattices and
    an utt2spk of two speakers, all made through the CLI on the CPU."""
    from kaldi_tpu_torch.io.wave import write_wave
    os.makedirs(G(), exist_ok=True)
    texts = []
    with open(G("wav.scp"), "w") as f:
        for i in range(8):
            ws = [str(rng.choice(["YES", "NO"]))
                  for _ in range(rng.randint(2, 5))]
            write_wave(G(f"y{i}.wav"), yesno_synth(ws, rng), GMM_SR)
            f.write(f"y{i} {G(f'y{i}.wav')}\n")
            texts.append(f"y{i} {' '.join(ws)}\n")
    for name, text in (("text", "".join(texts)),
                       ("lexicon.txt", YESNO_LEXICON + "\n")):
        with open(G(name), "w") as f:
            f.write(text)
    feats, ali = f"ark:{G('feats.ark')}", f"ark:{G('ali.ark')}"
    cpu = ["--device", "cpu"]
    for argv in (
            ["compute-mfcc-feats", G("wav.scp"), f"ark:{G('mfcc.ark')}",
             "--sample-frequency", CLI_SR, "--dither", "0", *cpu],
            ["add-deltas", f"ark:{G('mfcc.ark')}", feats, *cpu],
            ["train-mono", G("lexicon.txt"), G("text"), feats,
             G("mono.npz"), "--num-iters", "6", "--totgauss", "30", *cpu],
            ["gmm-align", G("mono.npz"), G("text"), feats, ali, *cpu],
            ["ali-to-post", ali, G("post.txt")],
            ["gmm-compute-likes", G("mono.npz"), feats,
             f"ark:{G('likes.ark')}", *cpu],
            ["acc-tree-stats", G("mono.npz"), feats, ali, G("ts.npz")],
            ["build-tree", G("mono.npz"), G("ts.npz"), G("tree.npz"),
             "--max-leaves", "20"],
            ["gmm-acc-stats-ali", G("mono.npz"), feats, ali, G("acc.npz"),
             *cpu],
            ["init-ubm", G("mono.npz"), G("acc.npz"), G("fubm.npz"),
             "--ubm-num-gauss", "4"],
            ["gmm-global-acc-stats", G("fubm.npz"), feats, G("facc.npz")]):
        _cli_ok(argv[0], cli_call(argv))
    for name, text in (("lm.arpa", YESNO_ARPA), ("bigram.arpa", YESNO_BIGRAM)):
        with open(G(name), "w") as f:
            f.write(text)
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    load_gmm_system(G("mono.npz"), device="cpu").lang.words.write(
        G("words.txt"))
    for argv in (
            ["mkgraph", G("mono.npz"), G("lm.arpa"), G("hclg.npz")],
            ["arpa2fst", G("lm.arpa"), G("words.txt"), G("G.txt")],
            ["arpa-to-const-arpa", G("words.txt"), G("bigram.arpa"),
             G("bigram.npz")],
            ["gmm-latgen-faster", G("mono.npz"), G("hclg.npz"), feats,
             "--lattice-out", G("lat.ark"), *CLI_LATGEN, *cpu]):
        _cli_ok(argv[0], cli_call(argv))
    with open(G("utt2spk"), "w") as f:
        f.writelines(f"y{i} s{i % 2}\n" for i in range(8))
    with open(G("post.txt")) as f, open(G("signed.txt"), "w") as g:
        for i, line in enumerate(f):
            toks = line.split()
            if i % 2:       # every other utterance a denominator
                toks = [t if k % 2 == 0 or t in "[]" else
                        f"{-0.5 * float(t):.6g}" for k, t in enumerate(toks)]
            g.write(" ".join(toks) + "\n")


def _ark(P, n):
    return f"ark:{P(n)}"


def word_id(words_txt: str, word: str) -> str:
    """`word`'s id in a words.txt, as a command-line argument."""
    with open(words_txt) as f:
        return next(i for w, i in (ln.split() for ln in f) if w == word)


# (name, argv(P, O), how the two runs compare, the ark compared): "bytes"
# for host commands (every file written byte-equal, stdout and exit code
# equal); for device commands the bound of the module's parity test, and
# for the spectrogram, fbank and MFCC that bound plus the FFT's error
# bound (fft_feature_bound)
CLI_CASES = [
    *[(f"compute-{k}-feats", lambda P, O, k=k: [
        f"compute-{k}-feats", P("wav.scp"), f"ark,scp:{O}/f.ark,{O}/f.scp",
        "--sample-frequency", CLI_SR, "--dither", "0"], kind, "f.ark")
      for k, kind in (("mfcc", "mfcc"), ("fbank", "fbank"),
                      ("spectrogram", "spec"), ("plp", "feat"),
                      ("pitch", "pitch"))],
    ("compute-kaldi-pitch-feats", lambda P, O: [
        "compute-kaldi-pitch-feats", P("wav.scp"), f"ark:{O}/f.ark",
        "--sample-frequency", CLI_SR], "pitch", "f.ark"),
    ("compute-and-process-kaldi-pitch-feats", lambda P, O: [
        "compute-and-process-kaldi-pitch-feats", P("wav.scp"),
        f"ark:{O}/f.ark", "--sample-frequency", CLI_SR], "pitch", "f.ark"),
    ("add-deltas", lambda P, O: ["add-deltas", _ark(P, "feats.ark"),
                                 f"ark:{O}/f.ark"], "exact", "f.ark"),
    ("add-deltas-sdc", lambda P, O: ["add-deltas-sdc", _ark(P, "feats.ark"),
                                     f"ark:{O}/f.ark"], "exact", "f.ark"),
    ("splice-feats", lambda P, O: ["splice-feats", _ark(P, "feats.ark"),
                                   f"ark:{O}/f.ark"], "exact", "f.ark"),
    ("apply-cmvn", lambda P, O: [
        "apply-cmvn", _ark(P, "cmvn.ark"), _ark(P, "feats.ark"),
        f"ark:{O}/f.ark", "--norm-vars"], "exact", "f.ark"),
    ("apply-cmvn-sliding", lambda P, O: [
        "apply-cmvn-sliding", _ark(P, "feats.ark"), f"ark:{O}/f.ark",
        "--cmn-window", "30", "--min-window", "10", "--norm-vars"],
     "sliding", "f.ark"),
    ("transform-feats", lambda P, O: [
        "transform-feats", P("affine.ark"), _ark(P, "feats.ark"),
        f"ark:{O}/f.ark"], "exact", "f.ark"),
    ("wav-reverberate", lambda P, O: [
        "wav-reverberate", P("u0.wav"), P("rir.wav"), f"{O}/r.wav"],
     "wav", "r.wav"),
    ("compute-cmvn-stats", lambda P, O: [
        "compute-cmvn-stats", _ark(P, "feats.ark"), f"ark:{O}/s.ark",
        "--spk2utt", P("spk2utt")], "bytes", None),
    ("compute-cmvn-stats-two-channel", lambda P, O: [
        "compute-cmvn-stats-two-channel", P("reco2file_and_channel"),
        _ark(P, "feats.ark"), f"ark:{O}/s.ark"], "bytes", None),
    ("apply-cmvn-online", lambda P, O: [
        "apply-cmvn-online", _ark(P, "feats.ark"), f"ark:{O}/f.ark",
        "--cmn-window", "20"], "bytes", None),
    ("modify-cmvn-stats", lambda P, O: [
        "modify-cmvn-stats", _ark(P, "cmvn.ark"), f"ark:{O}/s.ark"],
     "bytes", None),
    ("compute-vad", lambda P, O: ["compute-vad", _ark(P, "feats.ark"),
                                  f"ark:{O}/v.ark"], "bytes", None),
    ("select-voiced-frames", lambda P, O: [
        "select-voiced-frames", _ark(P, "feats.ark"), _ark(P, "vad.ark"),
        f"ark:{O}/f.ark"], "bytes", None),
    ("create-split-from-vad", lambda P, O: [
        "create-split-from-vad", _ark(P, "vad.ark"), f"{O}/segments",
        "--max-voiced", "12"], "bytes", None),
    *[(n, lambda P, O, n=n: [n, _ark(P, "pitch.ark"), f"ark:{O}/p.ark"],
       "bytes", None) for n in ("process-pitch-feats",
                                "process-kaldi-pitch-feats",
                                "interpolate-pitch")],
    ("detect-sinusoids", lambda P, O: ["detect-sinusoids", P("wav.scp")],
     "bytes", None),
    ("copy-feats", lambda P, O: ["copy-feats", f"scp:{P('feats.scp')}",
                                 f"ark,scp:{O}/c.ark,{O}/c.scp",
                                 "--compress"], "bytes", None),
    ("copy-feats-to-htk", lambda P, O: [
        "copy-feats-to-htk", _ark(P, "feats.ark"), f"{O}/htk"], "bytes",
     None),
    ("copy-feats-to-sphinx", lambda P, O: [
        "copy-feats-to-sphinx", _ark(P, "feats.ark"), f"{O}/sphinx"],
     "bytes", None),
    ("paste-feats", lambda P, O: [
        "paste-feats", _ark(P, "feats.ark"), _ark(P, "short.ark"),
        f"ark:{O}/p.ark", "--length-tolerance", "1"], "bytes", None),
    ("append-feats", lambda P, O: [
        "append-feats", _ark(P, "feats.ark"), _ark(P, "short.ark"),
        f"ark:{O}/a.ark"], "bytes", None),
    ("append-vector-to-feats", lambda P, O: [
        "append-vector-to-feats", _ark(P, "feats.ark"), _ark(P, "vecs.ark"),
        f"ark:{O}/a.ark"], "bytes", None),
    ("select-feats", lambda P, O: ["select-feats", "0-2,5",
                                   _ark(P, "feats.ark"), f"ark:{O}/s.ark"],
     "bytes", None),
    ("subset-feats", lambda P, O: ["subset-feats", _ark(P, "feats.ark"),
                                   f"ark:{O}/s.ark", "--n", "2"],
     "bytes", None),
    ("subsample-feats", lambda P, O: [
        "subsample-feats", _ark(P, "feats.ark"), f"ark:{O}/s.ark", "--n",
        "3"], "bytes", None),
    ("shift-feats", lambda P, O: ["shift-feats", _ark(P, "feats.ark"),
                                  f"ark:{O}/s.ark", "--shift", "2"],
     "bytes", None),
    *[(n, lambda P, O, n=n: [n, _ark(P, "feats.ark"), f"ark:{O}/r.ark"],
       "bytes", None) for n in ("reverse-feats", "remove-mean",
                                "matrix-sum-rows", "copy-matrix")],
    ("extract-rows", lambda P, O: ["extract-rows", P("ranges"),
                                   _ark(P, "feats.ark"), f"ark:{O}/r.ark"],
     "bytes", None),
    ("extract-segments", lambda P, O: [
        "extract-segments", P("wav.scp"), P("segments"), f"{O}/seg"],
     "bytes", None),
    ("extract-feature-segments", lambda P, O: [
        "extract-feature-segments", _ark(P, "feats.ark"), P("fsegments"),
        f"ark:{O}/s.ark"], "bytes", None),
    *[(n, lambda P, O, n=n: [n, _ark(P, "feats.ark")], "bytes", None)
      for n in ("feat-to-dim", "feat-to-len", "matrix-dim")],
    ("compare-feats", lambda P, O: ["compare-feats", _ark(P, "feats.ark"),
                                    _ark(P, "short.ark")], "bytes", None),
    ("copy-vector", lambda P, O: ["copy-vector", _ark(P, "vecs.ark"),
                                  f"ark,t:{O}/v.txt"], "bytes", None),
    ("copy-int-vector", lambda P, O: ["copy-int-vector", _ark(P, "ali.ark"),
                                      f"ark:{O}/a.ark"], "bytes", None),
    ("copy-int-vector-vector", lambda P, O: [
        "copy-int-vector-vector", f"ark:{P('ivv.txt')}", f"ark:{O}/c.txt"],
     "bytes", None),
    *[(n, lambda P, O, n=n: [n, f"ark:{O}/s.ark", _ark(P, "feats.ark"),
                             f"scp:{P('feats.scp')}"],
       "bytes", None) for n in ("matrix-sum", "sum-matrices")],
    ("matrix-logprob", lambda P, O: [
        "matrix-logprob", _ark(P, "feats.ark"), _ark(P, "ali.ark")],
     "bytes", None),
    ("duplicate-matrix", lambda P, O: [
        "duplicate-matrix", _ark(P, "feats.ark"), f"ark:{O}/d1.ark",
        f"ark,t:{O}/d2.txt"], "bytes", None),
    ("vector-scale", lambda P, O: ["vector-scale", _ark(P, "vecs.ark"),
                                   f"ark:{O}/v.ark", "--scale", "2"],
     "bytes", None),
    ("vector-sum", lambda P, O: ["vector-sum", f"ark:{O}/v.ark",
                                 _ark(P, "vecs.ark"), _ark(P, "vecs.ark")],
     "bytes", None),
    ("dot-weights", lambda P, O: ["dot-weights", _ark(P, "w1.ark"),
                                  _ark(P, "w2.ark"), f"ark:{O}/d.ark"],
     "bytes", None),
    ("reverse-weights", lambda P, O: ["reverse-weights", _ark(P, "w1.ark"),
                                      f"ark:{O}/r.ark"], "bytes", None),
    ("transform-vec", lambda P, O: ["transform-vec", P("vt.ark"),
                                    _ark(P, "vecs.ark"), f"ark:{O}/v.ark"],
     "bytes", None),
    ("compose-transforms", lambda P, O: [
        "compose-transforms", P("A.ark"), P("B_aff.ark"), f"{O}/c.ark"],
     "bytes", None),
    ("extend-transform-dim", lambda P, O: [
        "extend-transform-dim", P("B_aff.ark"), f"{O}/e.ark",
        "--new-dimension", "9"], "bytes", None),
    ("est-pca", lambda P, O: ["est-pca", _ark(P, "feats.ark"),
                              f"{O}/pca.ark", "--dim", "4"], "bytes", None),
    ("wav-copy", lambda P, O: ["wav-copy", P("u2.wav"), f"{O}/c.wav"],
     "bytes", None),
    ("wav-to-duration", lambda P, O: ["wav-to-duration", P("wav.scp")],
     "bytes", None),
    ("extend-wav-with-silence", lambda P, O: [
        "extend-wav-with-silence", P("wav.scp"), f"{O}/ext"], "bytes", None),
    ("split-scp", lambda P, O: ["split-scp", P("wav.scp"), "2",
                                f"{O}/part.JOB.scp"], "bytes", None),
    ("utt2spk-to-spk2utt", lambda P, O: ["utt2spk-to-spk2utt",
                                         P("utt2spk")], "bytes", None),
    ("compute-wer", lambda P, O: ["compute-wer", P("ref"), P("hyp")],
     "bytes", None),
    ("info", lambda P, O: ["info"], "bytes", None),
    # the second slice's device commands on cli_gmm_inputs' yesno system:
    # alignments identical; model files ("npz") array for array; the
    # accumulators ("accs") within CLI_ACC_REL of each array's largest
    # magnitude plus the bound that the gaussian loglikes' difference sets
    # (`accs_posterior_bound`); loglikes ("gmm") within CLI_LL_REL of their
    # GEMM terms; a
    # full UBM's eigenvalue floor ("eigh") within CLI_EIGH_REL; training
    # ("outcome") by its pdf and gaussian counts
    *[(n, lambda P, O, n=n: [n, P("gmm", "mono.npz"), P("gmm", "text"),
                             _ark(P, "gmm/feats.ark"), f"ark:{O}/a.ark"],
       "bytes", None) for n in ("align-equal", "align-equal-compiled")],
    *[(n, lambda P, O, n=n: [n, P("gmm", "mono.npz"), P("gmm", "text"),
                             _ark(P, "gmm/likes.ark"), f"ark:{O}/a.ark"],
       "bytes", None) for n in ("align-mapped", "align-compiled-mapped")],
    ("gmm-init-mono", lambda P, O: [
        "gmm-init-mono", P("gmm", "lexicon.txt"), _ark(P, "gmm/feats.ark"),
        f"{O}/m.npz"], "npz", None),
    ("gmm-init-model", lambda P, O: [
        "gmm-init-model", P("gmm", "mono.npz"), P("gmm", "tree.npz"),
        P("gmm", "ts.npz"), f"{O}/m.npz"], "npz", None),
    ("gmm-init-model-flat", lambda P, O: [
        "gmm-init-model-flat", P("gmm", "mono.npz"), P("gmm", "tree.npz"),
        f"{O}/m.npz", _ark(P, "gmm/feats.ark")], "npz", None),
    ("gmm-acc-stats-ali", lambda P, O: [
        "gmm-acc-stats-ali", P("gmm", "mono.npz"), _ark(P, "gmm/feats.ark"),
        _ark(P, "gmm/ali.ark"), f"{O}/a.npz"], "accs", None),
    ("gmm-acc-stats", lambda P, O: [
        "gmm-acc-stats", P("gmm", "mono.npz"), _ark(P, "gmm/feats.ark"),
        P("gmm", "post.txt"), f"{O}/a.npz"], "accs", None),
    ("gmm-acc-stats2", lambda P, O: [
        "gmm-acc-stats2", P("gmm", "mono.npz"), _ark(P, "gmm/feats.ark"),
        P("gmm", "signed.txt"), f"{O}/n.npz", f"{O}/d.npz"], "accs", None),
    ("gmm-compute-likes", lambda P, O: [
        "gmm-compute-likes", P("gmm", "mono.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/l.ark"], "gmm", "l.ark"),
    ("gmm-global-est", lambda P, O: [
        "gmm-global-est", P("gmm", "fubm.npz"), P("gmm", "facc.npz"),
        f"{O}/u.npz", "--min-gaussian-occupancy", "1"], "eigh", None),
    ("train-deltas", lambda P, O: [
        "train-deltas", P("gmm", "mono.npz"), P("gmm", "text"),
        _ark(P, "gmm/feats.ark"), f"{O}/m.npz", "--num-leaves", "20",
        "--totgauss", "60", "--num-iters", "4"], "outcome", "m.npz"),
    # the third slice's device commands on the same system: the lattices
    # of one loglike file ("lattice") with the same nodes and arcs, costs
    # within CLI_LAT_ATOL; the GMM decodes ("words") by their
    # transcriptions and lattice best paths; the GMM rescoring
    # ("rescored") with the same arcs, acoustic costs within the
    # loglikes' bound plus the lattice text's rounding
    ("latgen-faster-mapped", lambda P, O: [
        "latgen-faster-mapped", P("gmm", "hclg.npz"), _ark(P, "gmm/likes.ark"),
        "--lattice-out", f"{O}/lat.ark", *CLI_LATGEN], "lattice", "lat.ark"),
    ("gmm-latgen-faster", lambda P, O: [
        "gmm-latgen-faster", P("gmm", "mono.npz"), P("gmm", "hclg.npz"),
        _ark(P, "gmm/feats.ark"), "--determinize-lattice", "--lattice-out",
        f"{O}/lat.ark", "--transcription-out", f"{O}/hyp.txt", *CLI_LATGEN],
     "words", "hyp.txt"),
    *[(n, lambda P, O, n=n: [
        n, P("gmm", "mono.npz"), P("gmm", "hclg.npz"), P("gmm", "G.txt"),
        P("gmm", "bigram.npz"), _ark(P, "gmm/feats.ark"), "--backoff-symbol",
        word_id(P("gmm", "words.txt"), "#0"), "--transcription-out",
        f"{O}/hyp.txt", *CLI_LATGEN],
       "words", "hyp.txt")
      for n in ("gmm-latgen-biglm-faster", "gmm-decode-biglm-faster")],
    ("gmm-rescore-lattice", lambda P, O: [
        "gmm-rescore-lattice", P("gmm", "mono.npz"), P("gmm", "lat.ark"),
        _ark(P, "gmm/feats.ark"), f"{O}/lat.ark"], "rescored", "lat.ark"),
    ("decode-fmllr", lambda P, O: [
        "decode-fmllr", P("gmm", "mono.npz"), P("gmm", "hclg.npz"),
        _ark(P, "gmm/feats.ark"), P("gmm", "utt2spk"), "--transcription-out",
        f"{O}/hyp.txt", "--fmllr-min-count", "50", "--beam", "14",
        "--max-active", "64"], "words", "hyp.txt"),
]


def cli_nnet_inputs(N, G) -> None:
    """The fourth slice's device commands' inputs under N(name), from the
    GMM system under G(name) (cli_gmm_inputs), made through the port's
    CLI on the CPU: egs of context 2 + 2 and a validation subset, a
    p-norm TDNN AmNnet (nnet-am-init, then one epoch), a p-norm nnet3
    TDNN (make_tdnn_config, nnet3-init, one epoch), a sigmoid nnet1 net,
    pdf alignments and the discriminative egs of the GMM's lattices."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.nnet3.configs import make_tdnn_config
    os.makedirs(N(), exist_ok=True)
    pdfs = load_gmm_system(G("mono.npz"), device="cpu").am.num_pdfs
    with open(N("tdnn.config"), "w") as f:
        f.write(make_tdnn_config(39, pdfs, splice_indexes=((-1, 0, 1),
                                                           (-1, 1)),
                                 hidden_dim=32, nonlinearity="PnormComponent",
                                 pnorm_output_dim=8))
    with open(N("net.proto"), "w") as f:
        f.write(f"<AffineTransform> <InputDim> 39 <OutputDim> 16\n"
                f"<Sigmoid> <InputDim> 16 <OutputDim> 16\n"
                f"<AffineTransform> <InputDim> 16 <OutputDim> {pdfs}\n"
                f"<Softmax> <InputDim> {pdfs} <OutputDim> {pdfs}\n")
    feats, ali = f"ark:{G('feats.ark')}", f"ark:{G('ali.ark')}"
    one = ["--num-epochs", "1", "--minibatch-size", "16", "--device", "cpu"]
    for argv in (
            ["nnet-get-egs", G("mono.npz"), feats, ali, N("egs"),
             "--left-context", "2", "--right-context", "2"],
            ["nnet-subset-egs", N("egs"), N("valid"), "--n", "16"],
            ["nnet-am-init", G("mono.npz"), feats, N("nn0.npz"),
             "--splice-indexes=-1,0,1;-1,1", "--hidden-dim", "32",
             "--pnorm-output-dim", "8"],
            ["nnet-train-simple", N("nn0.npz"), N("egs"), N("nn1.npz"),
             *one],
            ["nnet3-init", N("tdnn.config"), N("n3_0.npz")],
            ["nnet3-train", N("n3_0.npz"), N("egs"), N("n3_1.npz"), *one],
            ["nnet-initialize", N("net.proto"), N("init.nnet")],
            ["ali-to-pdf", G("mono.npz"), ali, f"ark:{N('pdf.ark')}"],
            ["nnet-get-egs-discriminative", N("nn1.npz"), feats, ali,
             G("lat.ark"), N("degs")]):
        _cli_ok(argv[0], cli_call(argv))


def _nn(P, *n):
    return P("nnet", *n)


# the fourth slice's device commands on the small nnet system
# (cli_nnet_inputs): forwards ("nnet", CLI_NNET_TOL); f32 trainers, fits
# and gradients ("train": each array within TRAIN_LIMITS["f32"] of its
# largest value); NG-SGD and the Adam-fitted combinations ("ng": 1e-4, as
# TRAIN_LIMITS["ng_sgd"] and tests/test_torch_surgery.py's combine);
# printed objectives ("printed": PRINTED_ATOL); averaged posteriors
# ("priors": CLI_PRIORS_BOUND); shrink ("shrink": the output layer within
# 1e-4, each hidden layer a scalar multiple, since the RMS normalize
# cancels its scale); the LSTM files ("lstm": their pickled params at
# TRAIN_LIMITS["f32"]); the RBM, whose hidden samples come from a
# generator on each side's device ("shapes": JAX's members, shapes and
# dtypes, finite); lattice decodes ("lattice")
NNET_CLI_CASES = [
    ("nnet3-compute", lambda P, O: [
        "nnet3-compute", _nn(P, "n3_1.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/y.ark"], "nnet", "y.ark"),
    ("nnet3-compute --use-priors", lambda P, O: [
        "nnet3-compute", _nn(P, "n3_1.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/y.ark", "--use-priors"], "nnet", "y.ark"),
    ("nnet-forward", lambda P, O: [
        "nnet-forward", _nn(P, "init.nnet"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/y.ark", "--apply-log"], "nnet", "y.ark"),
    ("nnet-train-frmshuff", lambda P, O: [
        "nnet-train-frmshuff", _nn(P, "init.nnet"), _ark(P, "gmm/feats.ark"),
        _ark(P, "nnet/pdf.ark"), f"{O}/t.nnet", "--minibatch-size", "64"],
     "train", None),
    ("rbm-train-cd1-frmshuff", lambda P, O: [
        "rbm-train-cd1-frmshuff", _ark(P, "gmm/feats.ark"), f"{O}/r.npz",
        "--hidden-dim", "16", "--num-epochs", "1", "--minibatch-size", "64"],
     "shapes", None),
    ("nnet3-train", lambda P, O: [
        "nnet3-train", _nn(P, "n3_0.npz"), _nn(P, "egs"), f"{O}/n.npz",
        "--num-epochs", "1", "--minibatch-size", "16"], "ng", None),
    ("nnet3-compute-prob", lambda P, O: [
        "nnet3-compute-prob", _nn(P, "n3_1.npz"), _nn(P, "valid")],
     "printed", None),
    ("nnet3-combine", lambda P, O: [
        "nnet3-combine", _nn(P, "valid"), f"{O}/c.npz", _nn(P, "n3_0.npz"),
        _nn(P, "n3_1.npz"), "--num-steps", "10"], "ng", None),
    ("nnet3-am-adjust-priors", lambda P, O: [
        "nnet3-am-adjust-priors", _nn(P, "n3_1.npz"),
        _ark(P, "gmm/feats.ark"), f"{O}/p.npz"], "priors", None),
    ("nnet3-latgen-faster", lambda P, O: [
        "nnet3-latgen-faster", P("gmm", "mono.npz"), _nn(P, "n3_1.npz"),
        P("gmm", "hclg.npz"), _ark(P, "gmm/feats.ark"), "--lattice-out",
        f"{O}/lat.ark", *CLI_LATGEN], "lattice", "lat.ark"),
    ("nnet-train-simple", lambda P, O: [
        "nnet-train-simple", _nn(P, "nn0.npz"), _nn(P, "egs"), f"{O}/n.npz",
        "--num-epochs", "1", "--minibatch-size", "16"], "train", None),
    ("nnet-combine-fast", lambda P, O: [
        "nnet-combine-fast", _nn(P, "valid"), f"{O}/c.npz",
        _nn(P, "nn0.npz"), _nn(P, "nn1.npz"), "--num-steps", "10"],
     "ng", None),
    ("nnet-adjust-priors", lambda P, O: [
        "nnet-adjust-priors", _nn(P, "nn1.npz"), _ark(P, "gmm/feats.ark"),
        f"{O}/p.npz"], "priors", None),
    ("nnet-latgen-faster", lambda P, O: [
        "nnet-latgen-faster", P("gmm", "mono.npz"), _nn(P, "nn1.npz"),
        P("gmm", "hclg.npz"), _ark(P, "gmm/feats.ark"), "--lattice-out",
        f"{O}/lat.ark", *CLI_LATGEN], "lattice", "lat.ark"),
    *[(n, lambda P, O, n=n: [
        n, _nn(P, "nn1.npz"), _nn(P, "valid"), f"{O}/s.npz", "--num-steps",
        "5"], "shrink", None) for n in ("nnet-am-shrink", "nnet-shrink")],
    ("nnet-am-fix", lambda P, O: [
        "nnet-am-fix", _nn(P, "nn1.npz"), _nn(P, "valid"), f"{O}/f.npz"],
     "train", None),
    ("nnet-am-rescale", lambda P, O: [
        "nnet-am-rescale", _nn(P, "nn1.npz"), _nn(P, "valid"), f"{O}/r.npz",
        "--num-iters", "2"], "train", None),
    ("nnet-am-stats", lambda P, O: [
        "nnet-am-stats", _nn(P, "nn1.npz"), "--egs", _nn(P, "valid")],
     "printed", None),
    ("nnet-show-progress", lambda P, O: [
        "nnet-show-progress", _nn(P, "nn0.npz"), _nn(P, "nn1.npz"),
        _nn(P, "valid")], "printed", None),
    ("nnet-limit-degradation", lambda P, O: [
        "nnet-limit-degradation", _nn(P, "nn1.npz"), _nn(P, "nn0.npz"),
        _nn(P, "valid"), f"{O}/l.npz"], "train", None),
    ("nnet-compute", lambda P, O: [
        "nnet-compute", _nn(P, "nn1.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/y.ark"], "nnet", "y.ark"),
    ("nnet-logprob", lambda P, O: [
        "nnet-logprob", _nn(P, "nn1.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/y.ark"], "nnet", "y.ark"),
    ("nnet-logprob2", lambda P, O: [
        "nnet-logprob2", _nn(P, "nn1.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/p.ark", f"ark:{O}/l.ark"], "nnet", "l.ark"),
    ("nnet-compute-prob", lambda P, O: [
        "nnet-compute-prob", _nn(P, "nn1.npz"), _nn(P, "valid")],
     "printed", None),
    ("nnet-compute-from-egs", lambda P, O: [
        "nnet-compute-from-egs", _nn(P, "nn1.npz"), _nn(P, "valid"),
        f"ark:{O}/y.ark"], "nnet", "y.ark"),
    ("nnet-gradient", lambda P, O: [
        "nnet-gradient", _nn(P, "nn1.npz"), _nn(P, "valid"), f"{O}/g.npz"],
     "train", None),
    ("nnet-train-simple-perturbed", lambda P, O: [
        "nnet-train-simple-perturbed", _nn(P, "nn0.npz"), _nn(P, "egs"),
        f"{O}/t.npz", "--num-epochs", "1", "--minibatch-size", "16"],
     "train", None),
    ("nnet-train-ensemble", lambda P, O: [
        "nnet-train-ensemble", _nn(P, "egs"), _nn(P, "nn0.npz"),
        _nn(P, "nn1.npz"), f"{O}/e0.npz", f"{O}/e1.npz", "--num-epochs",
        "1", "--minibatch-size", "16"], "train", None),
    ("nnet-train-discriminative-simple", lambda P, O: [
        "nnet-train-discriminative-simple", _nn(P, "nn1.npz"),
        P("gmm", "mono.npz"), _nn(P, "degs"), f"{O}/d.npz", "--criterion",
        "mmi"], "train", None),
    ("nnet-align-compiled", lambda P, O: [
        "nnet-align-compiled", P("gmm", "mono.npz"), _nn(P, "nn1.npz"),
        P("gmm", "text"), _ark(P, "gmm/feats.ark"), f"ark:{O}/a.ark"],
     "bytes", None),
    *[(n, lambda P, O, n=n: [
        n, _ark(P, "gmm/feats.ark"), _ark(P, "nnet/pdf.ark"), "init",
        f"{O}/l.npz", "--cell-dim", "8", "--proj-dim", "4", "--num-epochs",
        "1", "--learn-rate", "0.005"], "lstm", None)
      for n in ("nnet-train-lstm-streams", "nnet-train-blstm-streams")],
    *[(n, lambda P, O, n=n: [
        n, _nn(P, "init.nnet"), P("gmm", "mono.npz"),
        _ark(P, "gmm/feats.ark"), P("gmm", "lat.ark"), _ark(P, "gmm/ali.ark"),
        f"{O}/s.nnet", "--learn-rate", "0.01"], "train", None)
      for n in ("nnet-train-mmi-sequential", "nnet-train-mpe-sequential")],
    ("nnet3-compute-from-egs", lambda P, O: [
        "nnet3-compute-from-egs", _nn(P, "n3_1.npz"), _nn(P, "valid"),
        f"ark:{O}/y.ark"], "nnet", "y.ark"),
    ("nnet3-show-progress", lambda P, O: [
        "nnet3-show-progress", _nn(P, "n3_0.npz"), _nn(P, "n3_1.npz"),
        _nn(P, "valid")], "printed", None),
]
CLI_CASES += NNET_CLI_CASES


def _sre(P, *n):
    return P("sre", *n)


# the fifth slice's (5a) device commands on the small speaker corpus
# (cli_sre_inputs) and the GMM system (cli_gmm_inputs): the full UBM's
# update ("eigh"); UBM EM ("ubm": CLI_UBM_REL); extractor statistics
# ("post": CLI_POST_REL), its M-step from the same statistics ("eigh"), a
# whole extractor run ("em": CLI_EM_REL) and the i-vectors ("ivec", the
# same of each vector's largest value); logistic regression's weights
# ("lr": CLI_LR_REL); LDA+MLLT training by outcome (pdf and gaussian
# counts); the online features within the FFT's bound carried through
# the deltas ("online"); the online GMM decoder's words ("words")
SRE_CLI_CASES = [
    ("fgmm-global-est", lambda P, O: [
        "fgmm-global-est", P("gmm", "fubm.npz"), P("gmm", "facc.npz"),
        f"{O}/u.npz", "--min-gaussian-occupancy", "3"], "eigh", None),
    ("train-ubm", lambda P, O: [
        "train-ubm", _ark(P, "sre/f.ark"), f"{O}/u.npz", "--num-gauss",
        "4", "--num-iters", "3", "--full"], "ubm", None),
    ("train-ivector-extractor", lambda P, O: [
        "train-ivector-extractor", _sre(P, "fubm.npz"), _ark(P, "sre/f.ark"),
        f"{O}/e.npz", "--ivector-dim", "6", "--num-iters", "3",
        "--num-gselect", "4"], "em", None),
    ("ivector-extract", lambda P, O: [
        "ivector-extract", _sre(P, "ext1.npz"), _ark(P, "sre/f.ark"),
        f"ark:{O}/iv.ark", "--spk2utt", _sre(P, "spk2utt")], "ivec",
     "iv.ark"),
    ("ivector-extractor-acc-stats", lambda P, O: [
        "ivector-extractor-acc-stats", _sre(P, "ext0.npz"),
        _ark(P, "sre/f.ark"), f"{O}/a.npz", "--num-gselect", "3"], "post",
     None),
    ("ivector-extractor-est", lambda P, O: [
        "ivector-extractor-est", _sre(P, "ext0.npz"), _sre(P, "acc.npz"),
        f"{O}/e.npz"], "eigh", None),
    ("logistic-regression-train", lambda P, O: [
        "logistic-regression-train", _ark(P, "sre/iv.ark"),
        _sre(P, "utt2spk"), f"{O}/lr.npz", "--max-steps", "30"], "lr",
     None),
    ("train-lda-mllt", lambda P, O: [
        "train-lda-mllt", P("gmm", "mono.npz"), P("gmm", "text"),
        _ark(P, "gmm/mfcc.ark"), _ark(P, "gmm/feats.ark"), f"{O}/lm.npz",
        f"{O}/final.ark", "--num-iters", "4", "--totgauss", "50",
        "--num-leaves", "12", "--lda-dim", "12"], "outcome", "lm.npz"),
    ("online2-wav-dump-features", lambda P, O: [
        "online2-wav-dump-features", P("gmm", "wav.scp"), f"ark:{O}/f.ark",
        "--sample-frequency", CLI_SR, "--chunk-secs", "0.13"], "online",
     "f.ark"),
    ("online2-wav-gmm-latgen-faster", lambda P, O: [
        "online2-wav-gmm-latgen-faster", P("gmm", "mono.npz"),
        P("gmm", "hclg.npz"), P("gmm", "wav.scp"), "--transcription-out",
        f"{O}/hyp.txt", "--utt2spk", P("gmm", "utt2spk"),
        "--sample-frequency", CLI_SR, "--beam", "12", "--max-active", "64",
        "--adaptation-delay", "0.5", "--fmllr-min-count", "30"], "words",
     "hyp.txt"),
]
CLI_CASES += SRE_CLI_CASES


# the fifth slice's (5b) device commands, on the yesno GMM system
# (cli_gmm_inputs) and the adaptation and SGMM files made from it
# (cli_adapt_inputs), each held to tests/test_torch_cli_adapt.py's and
# test_torch_cli_sgmm.py's bound: "a_f64" for the SGMM2's f64 scoring,
# statistics and updates (ADAPT_CLI_REL, test_torch_sgmm.py's 1e-9);
# "a_solve" for HLDA's f64 cyclic row updates (its parity test's 1e-6);
# "a_fmllr" for the fMLLR-type transforms of f32 gaussian posteriors;
# "a_stats" for posterior-fed statistics (MAP means, basis and MLLR
# statistics); "a_basis" and "a_sbasis" for the two fMLLR bases by each
# vector's Rayleigh quotient under the CPU's scatter (their eigenvectors
# of near-equal eigenvalues rotate freely); train-sat by its pdf and
# gaussian counts ("outcome"), train-sgmm2 by its printed counts and
# loglike ("a_sgmm_outcome"); the decodes by their words ("words")
ADAPT_CLI_REL = {"a_f64": 1e-9, "a_solve": 1e-6, "a_fmllr": 2e-3,
                 "a_stats": 1e-3}
ADAPT_CLI_LIKE_TOL = 1e-2    # train-sgmm2's printed loglike per frame


def _ad(P, *n):
    return P("adapt", *n)


def _adg(P, *n):
    return P("gmm", *n)


def cli_adapt_inputs(A, G) -> None:
    """The fifth slice's (5b) device commands' inputs under A(name), made
    through the CLI on the CPU from the yesno GMM system under G(name):
    a regression tree and its fMLLR and MLLR transforms, an LVTLN file
    and warped features, a diagonal UBM, MAP-adapted models, an fMLLR
    basis and its statistics, HLDA statistics, the lattices' arc graphs,
    an SGMM2 (8 gaussians of the full UBM, phn-dim 10, spk-dim 3, split
    to 20 substates) with its statistics (plain and from signed
    posteriors), gaussian-level posteriors, fMLLR-basis statistics and
    lattices."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    os.makedirs(A(), exist_ok=True)
    feats, cpu = f"ark:{G('feats.ark')}", ["--device", "cpu"]
    spk = ["--utt2spk", G("utt2spk")]
    write_ark(A("warped.ark"), {
        k: (v * np.linspace(0.9, 1.1, v.shape[1])[None]).astype(np.float32)
        for k, v in open_rspecifier(feats)})
    for argv in (
            ["gmm-make-regtree", G("mono.npz"), A("regtree.npz"),
             "--max-leaves", "3"],
            ["gmm-init-lvtln", A("lvtln.npz"), "--dim", "39", "--warps",
             "0.9:1.0:1.1"],
            ["init-ubm", G("mono.npz"), G("acc.npz"), A("dubm.npz"),
             "--ubm-num-gauss", "6", "--fullcov-ubm", "false"],
            ["gmm-est-regtree-fmllr", G("mono.npz"), A("regtree.npz"), feats,
             G("post.txt"), f"ark:{A('rt.ark')}", "--min-count", "50",
             *spk, *cpu],
            ["gmm-est-regtree-mllr", G("mono.npz"), A("regtree.npz"), feats,
             G("post.txt"), f"ark:{A('rtm.ark')}", "--min-count", "50",
             *spk, *cpu],
            ["gmm-adapt-map", G("mono.npz"), feats, G("post.txt"),
             A("mapdir"), *spk, *cpu],
            ["gmm-basis-fmllr-training", G("mono.npz"), feats, G("post.txt"),
             A("basis.npz"), "--basis-size", "20", *spk, *cpu],
            ["gmm-basis-fmllr-accs", G("mono.npz"), feats, G("post.txt"),
             A("bacc.npz"), *spk, *cpu],
            ["gmm-acc-hlda", G("mono.npz"), feats, f"ark:{G('ali.ark')}",
             A("hlda.npz"), *cpu],
            ["lattice-arcgraph", G("lat.ark"), A("arcs.ark")],
            ["init-ubm", G("mono.npz"), G("acc.npz"), A("fubm.npz"),
             "--ubm-num-gauss", "8"],
            ["sgmm2-init", G("mono.npz"), A("fubm.npz"), A("sgmm0.npz"),
             "--phn-dim", "10", "--spk-dim", "3", "--num-gselect", "4",
             *cpu],
            ["sgmm2-acc-stats", A("sgmm0.npz"), G("mono.npz"), feats,
             G("post.txt"), A("sacc0.npz"), *cpu],
            ["sgmm2-est", A("sgmm0.npz"), A("sacc0.npz"), A("sgmm.npz"),
             "--split-substates", "20", *cpu],
            ["sgmm2-acc-stats", A("sgmm.npz"), G("mono.npz"), feats,
             G("post.txt"), A("sacc.npz"), *cpu],
            ["sgmm2-acc-stats2", A("sgmm.npz"), G("mono.npz"), feats,
             G("signed.txt"), A("num.npz"), A("den.npz"), *cpu],
            ["sgmm2-post-to-gpost", A("sgmm.npz"), G("mono.npz"), feats,
             G("post.txt"), A("gpost.pkl"), *cpu],
            ["sgmm-acc-fmllrbasis-ali", A("sgmm.npz"), G("mono.npz"), feats,
             f"ark:{G('ali.ark')}", A("fb.pkl"), *spk, *cpu],
            ["sgmm2-latgen-faster", A("sgmm.npz"), G("mono.npz"),
             G("hclg.npz"), feats, "--lattice-out", A("slat.ark"),
             *CLI_LATGEN, *cpu]):
        _cli_ok(argv[0], cli_call(argv))


ADAPT_CLI_CASES = [
    ("train-sat", lambda P, O: [
        "train-sat", _adg(P, "mono.npz"), _adg(P, "text"),
        _ark(P, "gmm/feats.ark"), _adg(P, "utt2spk"), f"{O}/sat.npz",
        f"ark:{O}/t.ark", "--num-iters", "4", "--totgauss", "40",
        "--num-leaves", "12", "--fmllr-min-count", "50"], "outcome",
     "sat.npz"),
    ("gmm-est-fmllr", lambda P, O: [
        "gmm-est-fmllr", _adg(P, "mono.npz"), _ark(P, "gmm/feats.ark"),
        _adg(P, "post.txt"), f"ark:{O}/t.ark", "--min-count", "50",
        "--utt2spk", _adg(P, "utt2spk")], "a_fmllr", None),
    ("gmm-train-lvtln-special", lambda P, O: [
        "gmm-train-lvtln-special", "2", _ad(P, "lvtln.npz"),
        _ark(P, "gmm/feats.ark"), _ark(P, "adapt/warped.ark"),
        f"{O}/l.npz"], "a_f64", None),
    ("gmm-est-lvtln-trans", lambda P, O: [
        "gmm-est-lvtln-trans", _adg(P, "mono.npz"), _ad(P, "lvtln.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"ark:{O}/t.ark",
        "--utt2spk", _adg(P, "utt2spk")], "a_fmllr", None),
    ("gmm-adapt-map", lambda P, O: [
        "gmm-adapt-map", _adg(P, "mono.npz"), _ark(P, "gmm/feats.ark"),
        _adg(P, "post.txt"), f"{O}/mapdir", "--utt2spk",
        _adg(P, "utt2spk")], "a_stats", None),
    ("gmm-est-regtree-fmllr", lambda P, O: [
        "gmm-est-regtree-fmllr", _adg(P, "mono.npz"), _ad(P, "regtree.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"ark:{O}/t.ark",
        "--min-count", "50", "--utt2spk", _adg(P, "utt2spk")], "a_fmllr",
     None),
    ("gmm-basis-fmllr-training", lambda P, O: [
        "gmm-basis-fmllr-training", _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"{O}/b.npz",
        "--basis-size", "20", "--utt2spk", _adg(P, "utt2spk")], "a_basis",
     "b.npz"),
    ("gmm-est-basis-fmllr", lambda P, O: [
        "gmm-est-basis-fmllr", _adg(P, "mono.npz"), _ad(P, "basis.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"ark:{O}/t.ark",
        "--utt2spk", _adg(P, "utt2spk")], "a_fmllr", None),
    ("train-sgmm2", lambda P, O: [
        "train-sgmm2", _adg(P, "mono.npz"), _adg(P, "text"),
        _ark(P, "gmm/feats.ark"), f"{O}/s.npz", "--ubm-gauss", "8",
        "--phn-dim", "8", "--num-iters", "3", "--num-gselect", "4"],
     "a_sgmm_outcome", "s.npz"),
    ("sgmm2-latgen-faster", lambda P, O: [
        "sgmm2-latgen-faster", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _adg(P, "hclg.npz"), _ark(P, "gmm/feats.ark"), "--lattice-out",
        f"{O}/lat.ark", "--transcription-out", f"{O}/hyp.txt", *CLI_LATGEN],
     "words", "hyp.txt"),
    ("sgmm2-gselect", lambda P, O: [
        "sgmm2-gselect", _ad(P, "sgmm.npz"), _ark(P, "gmm/feats.ark"),
        f"ark:{O}/g.ark", "--num-gselect", "4"], "a_f64", None),
    ("sgmm2-acc-stats", lambda P, O: [
        "sgmm2-acc-stats", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"{O}/a.npz"],
     "a_f64", None),
    ("sgmm2-est", lambda P, O: [
        "sgmm2-est", _ad(P, "sgmm.npz"), _ad(P, "sacc.npz"), f"{O}/s.npz",
        "--split-substates", "25"], "a_f64", None),
    ("sgmm2-est-ebw", lambda P, O: [
        "sgmm2-est-ebw", _ad(P, "sgmm.npz"), _ad(P, "num.npz"),
        _ad(P, "den.npz"), f"{O}/s.npz"], "a_f64", None),
    ("sgmm2-align", lambda P, O: [
        "sgmm2-align", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _adg(P, "text"), _ark(P, "gmm/feats.ark"), f"ark:{O}/a.ark"],
     "a_f64", None),
    ("sgmm2-est-spkvecs", lambda P, O: [
        "sgmm2-est-spkvecs", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"ark:{O}/v.ark",
        "--utt2spk", _adg(P, "utt2spk")], "a_f64", None),
    # cli_adapt.py
    ("gmm-global-est-lvtln-trans", lambda P, O: [
        "gmm-global-est-lvtln-trans", _ad(P, "dubm.npz"),
        _ad(P, "lvtln.npz"), _ark(P, "gmm/feats.ark"), f"ark:{O}/t.ark",
        "--utt2spk", _adg(P, "utt2spk")], "a_fmllr", None),
    ("gmm-acc-hlda", lambda P, O: [
        "gmm-acc-hlda", _adg(P, "mono.npz"), _ark(P, "gmm/feats.ark"),
        _ark(P, "gmm/ali.ark"), f"{O}/h.npz"], "a_f64", None),
    ("gmm-est-hlda", lambda P, O: [
        "gmm-est-hlda", f"{O}/h.ark", _ad(P, "hlda.npz"), _ad(P, "hlda.npz"),
        "--keep-dims", "20"], "a_solve", None),
    ("gmm-basis-fmllr-accs", lambda P, O: [
        "gmm-basis-fmllr-accs", _adg(P, "mono.npz"), _ark(P, "gmm/feats.ark"),
        _adg(P, "post.txt"), f"{O}/b.npz", "--utt2spk", _adg(P, "utt2spk")],
     "a_stats", None),
    ("gmm-basis-fmllr-accs-gpost", lambda P, O: [
        "gmm-basis-fmllr-accs-gpost", _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"{O}/b.npz"],
     "a_stats", None),
    ("gmm-est-regtree-mllr", lambda P, O: [
        "gmm-est-regtree-mllr", _adg(P, "mono.npz"), _ad(P, "regtree.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"ark:{O}/t.ark",
        "--min-count", "50", "--utt2spk", _adg(P, "utt2spk")], "a_mllr",
     "t.ark"),
    ("gmm-est-regtree-fmllr-ali", lambda P, O: [
        "gmm-est-regtree-fmllr-ali", _adg(P, "mono.npz"),
        _ad(P, "regtree.npz"), _ark(P, "gmm/feats.ark"),
        _ark(P, "gmm/ali.ark"), f"ark:{O}/t.ark", "--min-count", "50",
        "--utt2spk", _adg(P, "utt2spk")], "a_fmllr", None),
    ("gmm-decode-faster-regtree-fmllr", lambda P, O: [
        "gmm-decode-faster-regtree-fmllr", _adg(P, "mono.npz"),
        _ad(P, "regtree.npz"), _adg(P, "hclg.npz"), _ark(P, "gmm/feats.ark"),
        _ad(P, "rt.ark"), "--utt2spk", _adg(P, "utt2spk"),
        "--transcription-out", f"{O}/hyp.txt", *CLI_LATGEN], "words",
     "hyp.txt"),
    ("gmm-decode-faster-regtree-mllr", lambda P, O: [
        "gmm-decode-faster-regtree-mllr", _adg(P, "mono.npz"),
        _ad(P, "regtree.npz"), _adg(P, "hclg.npz"), _ark(P, "gmm/feats.ark"),
        _ad(P, "rtm.ark"), "--utt2spk", _adg(P, "utt2spk"),
        "--transcription-out", f"{O}/hyp.txt", *CLI_LATGEN], "words",
     "hyp.txt"),
    ("gmm-latgen-faster-regtree-fmllr", lambda P, O: [
        "gmm-latgen-faster-regtree-fmllr", _adg(P, "mono.npz"),
        _ad(P, "regtree.npz"), _adg(P, "hclg.npz"), _ark(P, "gmm/feats.ark"),
        _ad(P, "rt.ark"), "--utt2spk", _adg(P, "utt2spk"),
        "--transcription-out", f"{O}/hyp.txt", "--lattice-out",
        f"{O}/lat.ark", *CLI_LATGEN], "words", "hyp.txt"),
    ("gmm-decode-nbest", lambda P, O: [
        "gmm-decode-nbest", _adg(P, "mono.npz"), _adg(P, "hclg.npz"),
        _ark(P, "gmm/feats.ark"), "--n", "3", "--transcription-out",
        f"{O}/hyp.txt", *CLI_LATGEN], "words", "hyp.txt"),
    ("gmm-latgen-map", lambda P, O: [
        "gmm-latgen-map", _adg(P, "mono.npz"), _ad(P, "mapdir"),
        _adg(P, "hclg.npz"), _ark(P, "gmm/feats.ark"), "--utt2spk",
        _adg(P, "utt2spk"), "--transcription-out", f"{O}/hyp.txt",
        *CLI_LATGEN], "words", "hyp.txt"),
    ("gmm-latgen-tracking", lambda P, O: [
        "gmm-latgen-tracking", _adg(P, "mono.npz"), _ark(P, "gmm/feats.ark"),
        _ark(P, "adapt/arcs.ark"), "--transcription-out", f"{O}/hyp.txt",
        "--lattice-out", f"{O}/lat.ark", *CLI_LATGEN], "words", "hyp.txt"),
    ("latgen-tracking-mapped", lambda P, O: [
        "latgen-tracking-mapped", _adg(P, "mono.npz"),
        _ark(P, "gmm/likes.ark"), _ark(P, "adapt/arcs.ark"),
        "--transcription-out", f"{O}/hyp.txt", *CLI_LATGEN], "words",
     "hyp.txt"),
    # cli_sgmm.py
    ("sgmm2-init", lambda P, O: [
        "sgmm2-init", _adg(P, "mono.npz"), _ad(P, "fubm.npz"),
        f"{O}/s.npz", "--phn-dim", "10", "--spk-dim", "3",
        "--num-gselect", "4", "--seed", "2"], "a_f64", None),
    ("sgmm-mixup", lambda P, O: [
        "sgmm-mixup", _ad(P, "sgmm.npz"), f"{O}/s.npz", "--num-substates",
        "30", "--read-occs", _ad(P, "sacc.npz"), "--increase-phn-dim", "12",
        "--increase-spk-dim", "4"], "a_f64", None),
    ("sgmm-calc-distances", lambda P, O: [
        "sgmm-calc-distances", _ad(P, "sgmm.npz"), _ad(P, "sacc.npz"),
        f"{O}/d.ark"], "a_f64", None),
    ("sgmm2-post-to-gpost", lambda P, O: [
        "sgmm2-post-to-gpost", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"{O}/g.pkl"],
     "a_f64", None),
    ("sgmm2-acc-stats-gpost", lambda P, O: [
        "sgmm2-acc-stats-gpost", _ad(P, "sgmm.npz"), _ark(P, "gmm/feats.ark"),
        _ad(P, "gpost.pkl"), f"{O}/a.npz"], "a_f64", None),
    ("sgmm2-acc-stats2", lambda P, O: [
        "sgmm2-acc-stats2", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "signed.txt"), f"{O}/n.npz",
        f"{O}/d.npz"], "a_f64", None),
    ("sgmm-acc-stats-ali", lambda P, O: [
        "sgmm-acc-stats-ali", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _ark(P, "gmm/ali.ark"), f"{O}/a.npz"],
     "a_f64", None),
    ("sgmm-est-multi", lambda P, O: [
        "sgmm-est-multi", _ad(P, "sgmm.npz"), _ad(P, "sacc.npz"),
        f"{O}/o1.npz", _ad(P, "sgmm.npz"), _ad(P, "num.npz"),
        f"{O}/o2.npz"], "a_f64", None),
    ("sgmm2-est-fmllr", lambda P, O: [
        "sgmm2-est-fmllr", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _adg(P, "post.txt"), f"ark:{O}/t.ark",
        "--fmllr-min-count", "50", "--utt2spk", _adg(P, "utt2spk")],
     "a_f64", None),
    ("sgmm2-comp-prexform", lambda P, O: [
        "sgmm2-comp-prexform", _ad(P, "sgmm.npz"), _ad(P, "sacc.npz"),
        f"{O}/s.npz"], "a_f64", None),
    ("sgmm-acc-fmllrbasis-ali", lambda P, O: [
        "sgmm-acc-fmllrbasis-ali", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ark(P, "gmm/feats.ark"), _ark(P, "gmm/ali.ark"), f"{O}/fb.pkl",
        "--utt2spk", _adg(P, "utt2spk")], "a_f64", None),
    ("sgmm-est-fmllrbasis", lambda P, O: [
        "sgmm-est-fmllrbasis", _ad(P, "sgmm.npz"), f"{O}/s.npz",
        _ad(P, "fb.pkl"), "--num-bases", "10"], "a_sbasis", "s.npz"),
    ("sgmm2-rescore-lattice", lambda P, O: [
        "sgmm2-rescore-lattice", _ad(P, "sgmm.npz"), _adg(P, "mono.npz"),
        _ad(P, "slat.ark"), _ark(P, "gmm/feats.ark"), f"{O}/lat.ark"],
     "lattice", "lat.ark"),
]
CLI_CASES += ADAPT_CLI_CASES


def _pickled_rel(a, b, rel: float, name: str) -> float:
    """Two unpickled results (the card's, the CPU's): containers element
    for element, float arrays within `rel` of their largest magnitude,
    the rest equal. -> the worst relative difference."""
    if isinstance(b, dict):
        if list(a) != list(b):
            raise AssertionError(f"{name}: keys differ")
        return max([_pickled_rel(a[k], b[k], rel, name) for k in b] + [0.0])
    if isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise AssertionError(f"{name}: lengths differ")
        return max([_pickled_rel(x, y, rel, name) for x, y in zip(a, b)]
                   + [0.0])
    if isinstance(b, (np.ndarray, float)) and np.asarray(b).dtype.kind == "f":
        x, y = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if x.shape != y.shape:
            raise AssertionError(f"{name}: shapes differ")
        r = float(np.abs(x - y).max(initial=0.0)
                  / max(float(np.abs(y).max(initial=0.0)), 1e-300))
        if r > rel:
            raise AssertionError(f"{name}: {r:.3e} of the largest value "
                                 f"apart (limit {rel})")
        return r
    if not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError(f"{name}: values differ")
    return 0.0


def _printed_close(name: str, out: dict, rtol: float):
    """The command's own lines (stdout and its stderr lines), card against
    CPU: the same words, each number within rtol of its size plus the
    4th printed decimal."""
    def lines(o):
        return o[0].splitlines() + [ln for ln in o[3].splitlines()
                                    if ln.startswith(f"{name}:")]
    a, b = lines(out["card"]), lines(out["cpu"])
    if len(a) != len(b):
        raise AssertionError(f"{name}: different output")
    for x, y in zip(a, b):
        nx, ny = _printed_numbers(x), _printed_numbers(y)
        if len(nx) != len(ny) or not np.allclose(nx, ny, rtol=rtol,
                                                 atol=PRINTED_ATOL):
            raise AssertionError(f"{name}: {x!r} vs {y!r}")


def basis_quotients(basis: np.ndarray, scatter: np.ndarray,
                    metric: np.ndarray | None = None) -> np.ndarray:
    """Each basis vector's Rayleigh quotient b' S b / b' H b (H the
    identity when None): what the basis, leading eigenvectors of S in
    the H metric, captures, whatever their rotation within near-equal
    eigenvalues."""
    V = basis.reshape(len(basis), -1)
    den = np.einsum("ki,ki->k", V, V) if metric is None else \
        np.einsum("ki,ij,kj->k", V, metric, V)
    return np.einsum("ki,ij,kj->k", V, scatter, V) / den


def sgmm_basis_scatter(model: str, stats: str) -> np.ndarray:
    """sgmm-est-fmllrbasis's scatter of the speakers' fMLLR gradients at
    the identity over sqrt(beta), from its statistics file, on the CPU."""
    import pickle

    import torch
    from kaldi_tpu_torch.io.model_io import load_sgmm2
    from kaldi_tpu_torch.sgmm.fmllr import FmllrSgmm2Accs
    from kaldi_tpu_torch.sgmm.prexform import fmllr_grad_at_identity
    m = load_sgmm2(model, device="cpu").sgmm
    S = 0.0
    with open(stats, "rb") as f:
        for _spk, (beta, K, G) in pickle.load(f).items():
            st = FmllrSgmm2Accs(m)
            st._beta = torch.tensor(beta, dtype=torch.float64)
            st.K = torch.as_tensor(K, dtype=torch.float64)
            st.G = torch.as_tensor(G, dtype=torch.float64)
            g = fmllr_grad_at_identity(st, m).reshape(-1).numpy()
            S = S + np.outer(g, g) / beta
    return S


def adapt_files_close(kind: str, dc: str, dp: str, out: dict, name: str,
                      P) -> float:
    """The fifth slice's (5b) device cases, card (dc) against CPU (dp):
    the command's lines within the kind's bound, the same files, model
    and statistics files (npz_rel), arks and pickles within the kind's
    bound (ADAPT_CLI_REL; integer arks equal); the MLLR transforms by
    the adapted means of their leaves' gaussians; the two bases by their
    Rayleigh quotients under the CPU's scatter; train-sgmm2 by its counts
    and loglike. -> the worst relative difference."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    rel = ADAPT_CLI_REL.get(kind, ADAPT_CLI_REL["a_stats"])
    if _cli_files(dc) != _cli_files(dp):
        raise AssertionError(f"{name}: different files")
    if kind == "a_sgmm_outcome":
        a, b = (o[3].strip().splitlines()[-1].rsplit(" ", 1)
                for o in (out["card"], out["cpu"]))
        if a[0] != b[0] or abs(float(a[1]) - float(b[1])) > \
                ADAPT_CLI_LIKE_TOL:
            raise AssertionError(f"{name}: {a} vs {b}")
        return abs(float(a[1]) - float(b[1]))
    _printed_close(name, out, 0.0 if kind == "a_f64" else rel)
    if kind in ("a_basis", "a_sbasis"):
        key = "basis" if kind == "a_basis" else "__extra_fmllr_basis"
        if kind == "a_basis":
            z = np.load(_ad(P, "bacc.npz"))
            S, H = z["grad_scatter"], z["H"] / float(z["beta"])
        else:
            S, H = sgmm_basis_scatter(_ad(P, "sgmm.npz"), _ad(P, "fb.pkl")), \
                None
        qa, qb = (basis_quotients(np.load(os.path.join(d, "b.npz" if
                                                       kind == "a_basis"
                                                       else "s.npz"))[key],
                                  S, H) for d in (dc, dp))
        # a perturbation E of the scatter moves an eigenvector's quotient
        # under the unperturbed scatter by at most 2 |E|: the gradient
        # scatter of f32 posteriors is held as their statistics are
        # (a_stats), the SGMM's f64 one to 1e-6 of its largest quotient
        lim = ADAPT_CLI_REL["a_stats"] if kind == "a_basis" else 1e-6
        worst = float(np.abs(qa - qb).max() / np.abs(qb).max())
        if worst > lim:
            raise AssertionError(f"{name}: basis quotients {worst:.3e} "
                                 f"of the largest apart (limit {lim})")
        return worst
    worst = 0.0
    for f in _cli_files(dc):
        a, b = os.path.join(dc, f), os.path.join(dp, f)
        if f.endswith(".npz"):
            worst = max(worst, npz_rel(a, b, rel, name))
        elif f.endswith(".pkl"):
            import pickle
            with open(a, "rb") as x, open(b, "rb") as y:
                worst = max(worst, _pickled_rel(pickle.load(x),
                                                pickle.load(y), rel, name))
        elif f.endswith(".ark"):
            ga, wa = dict(read_ark(a)), dict(read_ark(b))
            if list(ga) != list(wa) or not wa:
                raise AssertionError(f"{name}: keys differ")
            for k in wa:
                if kind == "a_mllr":
                    worst = max(worst, _mllr_means_rel(P, ga[k], wa[k], name))
                    continue
                worst = max(worst, _pickled_rel(ga[k], wa[k], rel, name))
        elif open(a, "rb").read() != open(b, "rb").read():
            raise AssertionError(f"{name}: {f} differs")
    return worst


def _mllr_means_rel(P, got, want, name: str) -> float:
    """Regression-tree MLLR rows solve a leaf's system over its few
    gaussian means, whose span is all that the data determines: the two
    transforms' adapted means W [mu; 1] of each leaf's gaussians within
    ADAPT_CLI_REL["a_stats"] of their largest magnitude."""
    from kaldi_tpu_torch.cli import _load_regtree
    from kaldi_tpu_torch.transform.regtree import unstack_transforms
    tree = _load_regtree(_ad(P, "regtree.npz"))
    xi = np.concatenate([tree.means, np.ones((len(tree.means), 1))], 1)
    D = tree.means.shape[1]
    g, w = (unstack_transforms(tree, t, D) for t in (got, want))
    worst = 0.0
    for leaf in w:
        sel = tree.gauss2leaf == leaf
        worst = max(worst, _pickled_rel(xi[sel] @ g[leaf].T,
                                        xi[sel] @ w[leaf].T,
                                        ADAPT_CLI_REL["a_stats"], name))
    return worst


def _cli_files(d: str) -> list:
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _ds, fs in os.walk(d) for f in fs)


F32_EPS = 2.0 ** -24


def fft_feature_bound(wave, opts, kind: str) -> np.ndarray:
    """[T, D] bound on |a - b| of two f32 computations of the features
    `kind` ("spec", "fbank" or "mfcc") of `wave` under `opts` that differ
    in their FFT (the card's and the CPU's, or JAX's and the port's): the
    features' parity bound (CLI_FEAT_TOL, added by the caller) plus the
    FFT's rounding error per bin, of the order log2(N) eps ||x|| for a
    frame x (its normwise bound log2(N) eps ||X|| spread over the N bins),
    taken twice on each side: |dX_k| <= 4 log2(N) eps ||x||, carried to
    every power bin (2 |dX| |X_k| + |dX|^2), through the mel filters,
    through the log (-log(1 - de / e); unbounded where the error can reach
    the energy itself) and, for MFCC, the DCT and lifter. A bin far below
    its frame's power is where this outgrows the parity bound."""
    import torch
    from kaldi_tpu_torch.ops.dct import dct_matrix, lifter_coeffs
    from kaldi_tpu_torch.ops.mel import mel_banks
    from kaldi_tpu_torch.ops.window import extract_windows
    fo = opts.frame_opts
    x = extract_windows(torch.as_tensor(np.asarray(wave, np.float32)),
                        fo)[0].double()
    N = x.shape[-1]
    p = torch.fft.rfft(x).abs().square().numpy()
    dX = 4.0 * np.log2(N) * F32_EPS * np.linalg.norm(
        x.numpy(), axis=-1, keepdims=True)
    dp = 2.0 * dX * np.sqrt(p) + dX * dX

    def dlog(e, de):
        r = de / np.maximum(e, 1e-300)
        return np.where(r < 1.0, -np.log1p(-np.minimum(r, 1.0 - 1e-12)),
                        np.inf)
    if kind == "spec":
        out = np.zeros((p.shape[0], p.shape[1]))
        out[:, 1:] = dlog(p[:, 1:], dp[:, 1:])
        return out
    B = mel_banks(opts.mel_opts, fo).double().numpy()
    dlog_e = dlog(p[:, : N // 2] @ B.T, dp[:, : N // 2] @ B.T)
    if kind == "fbank":
        return dlog_e
    D = np.abs(dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
               .double().numpy())
    if opts.cepstral_lifter != 0.0:
        D = D * np.abs(lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)
                       .double().numpy())[:, None]
    with np.errstate(invalid="ignore"):
        out = dlog_e @ D.T
    if opts.use_energy:
        out[:, 0] = 0.0     # c0 is the frame's log energy, in time
    return np.nan_to_num(out, nan=np.inf)


def cli_fft_bounds(P, kind: str) -> dict:
    """{utt: fft_feature_bound} for CLI_CASES' feature cases (wav.scp's
    first channel at 8 kHz, dither 0, the subcommands' defaults)."""
    from kaldi_tpu_torch import ops
    from kaldi_tpu_torch.io.wave import read_wave
    fo = ops.FrameOpts(samp_freq=float(CLI_SR), dither=0.0)
    mel = ops.MelOpts(num_bins=23)
    opts = {"spec": ops.SpectrogramOpts(frame_opts=fo),
            "fbank": ops.FbankOpts(frame_opts=fo, mel_opts=mel),
            "mfcc": ops.MfccOpts(frame_opts=fo, mel_opts=mel)}[kind]
    with open(P("wav.scp")) as f:
        scp = [ln.split() for ln in f if ln.strip()]
    return {u: fft_feature_bound(read_wave(path)[0][0], opts, kind)
            for u, path in scp}


def _cli_close(kind: str, g, w, fft=None) -> float:
    """-> the worst |g - w|; raises past the kind's bound (plus the FFT's
    error bound `fft` where given; for "gmm" `fft` is the bound)."""
    g64, w64 = np.asarray(g, np.float64), np.asarray(w, np.float64)
    diff = np.abs(g64 - w64)
    if kind == "pitch":
        bound = CLI_PITCH_REL * np.maximum(np.abs(w64).max(axis=0), 1e-30)
    elif kind == "ivec":
        bound = np.full_like(w64, CLI_EM_REL * np.abs(w64).max(initial=0.0))
    elif kind == "wav":
        bound = np.ones_like(w64)          # one int16 step
    elif kind == "gmm":
        bound = fft
    else:
        tol = {"feat": CLI_FEAT_TOL, "exact": CLI_EXACT_TOL,
               "sliding": CLI_SLIDING_TOL, "nnet": CLI_NNET_TOL}[kind]
        bound = tol["atol"] + tol["rtol"] * np.abs(w64)
        if fft is not None:
            bound = bound + fft
    if not (diff <= bound).all():
        raise AssertionError(f"{kind}: {float(diff.max()):.3e} past its "
                             f"bound")
    return float(diff.max(initial=0.0))


def _lattice_arrays(lat):
    """-> (node count, int arc columns [A, 4] (src, ilabel, olabel, dst)
    sorted, their costs [A, 2] in that order, finals sorted)."""
    n, src, il, ol, gc, ac, dst = lat.to_arrays()
    ints = np.stack([np.asarray(a, np.int64) for a in (src, il, ol, dst)], 1)
    costs = np.stack([np.asarray(gc, np.float64),
                      np.asarray(ac, np.float64)], 1)
    order = np.lexsort((costs[:, 1], costs[:, 0], ints[:, 3], ints[:, 2],
                        ints[:, 1], ints[:, 0]))
    finals = sorted((int(s), float(g), float(a))
                    for s, (g, a) in lat.finals.items())
    return n, ints[order], costs[order], finals


def lattices_within(a: str, b: str, name: str, atol, rel: float = 0.0
                    ) -> float:
    """Two lattice arks (the card's, then the CPU's): the same keys, and
    each lattice with the same node count and sorted (src, ilabel, olabel,
    dst) arcs, its arc and final costs within `atol` (a number, or one
    per key) plus `rel` of the lattice's largest cost, as
    tests/test_torch_lattice.py's `_same_lattice` holds the port to JAX.
    -> the worst cost difference."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    la, lb = (dict(read_lattice_ark(p)) for p in (a, b))
    if list(la) != list(lb) or not lb:
        raise AssertionError(f"{name}: lattice keys differ")
    worst = 0.0
    for k in lb:
        (na, ia, ca, fa), (nb, ib, cb, fb) = (_lattice_arrays(x)
                                              for x in (la[k], lb[k]))
        if na != nb or not np.array_equal(ia, ib) or \
                [f[0] for f in fa] != [f[0] for f in fb]:
            raise AssertionError(f"{name} {k}: the lattices differ")
        got = np.concatenate([ca.ravel(), np.ravel([f[1:] for f in fa])])
        want = np.concatenate([cb.ravel(), np.ravel([f[1:] for f in fb])])
        diff = float(np.abs(got - want).max(initial=0.0))
        tol = (atol[k] if isinstance(atol, dict) else atol) \
            + rel * float(np.abs(want).max(initial=0.0))
        if not diff <= tol:
            raise AssertionError(f"{name} {k}: lattice costs {diff:.3e} "
                                 f"apart, past {tol:.3e}")
        worst = max(worst, diff)
    return worst


def cli_compare(kind: str, dirs: dict, out: dict, name: str,
                ark: str | None, fft: dict | None = None) -> float:
    """Two runs of one subcommand (dirs/out by side, "card" and "cpu"):
    byte-equal files and output for a host command, the output ark or
    wave within the kind's bound (and `fft[key]`, an FFT error bound) for
    a device command. -> worst diff."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    dc, dp = dirs["card"], dirs["cpu"]
    if out["card"][1] != out["cpu"][1]:
        raise AssertionError(f"{name}: exit codes {out['card'][1]} / "
                             f"{out['cpu'][1]}")
    if kind == "bytes":
        if _cli_files(dc) != _cli_files(dp) or \
                out["card"][0].replace(dc, dp) != out["cpu"][0]:
            raise AssertionError(f"{name}: different files or output")
        for f in _cli_files(dc):
            a = open(os.path.join(dc, f), "rb").read()
            b = open(os.path.join(dp, f), "rb").read()
            if a.replace(dc.encode(), dp.encode()) != b:
                raise AssertionError(f"{name}: {f} differs")
        return 0.0
    if kind == "wav":
        (g, gs), (w, ws) = (read_wave(os.path.join(d, ark))
                            for d in (dc, dp))
        if gs != ws or g.shape != w.shape:
            raise AssertionError(f"{name}: wave header differs")
        return _cli_close(kind, g, w)
    if kind == "outcome":
        (g, w) = (np.load(os.path.join(d, ark)) for d in (dc, dp))
        if [int(g["num_pdfs"]), _num_gauss(g)] != \
                [int(w["num_pdfs"]), _num_gauss(w)]:
            raise AssertionError(f"{name}: pdf or gaussian counts differ")
        return 0.0
    if kind == "words":
        if _cli_files(dc) != _cli_files(dp) or out["card"][0] != \
                out["cpu"][0] or open(os.path.join(dc, ark)).read() != \
                open(os.path.join(dp, ark)).read():
            raise AssertionError(f"{name}: card and CPU words differ")
        if "lat.ark" in _cli_files(dc):
            best = [{k: lattice_best_path(lat)[0] for k, lat in
                     read_lattice_ark(os.path.join(d, "lat.ark"))}
                    for d in (dc, dp)]
            if best[0] != best[1]:
                raise AssertionError(f"{name}: lattice best paths differ")
        return 0.0
    if kind == "lattice":
        if out["card"][0] != out["cpu"][0]:
            raise AssertionError(f"{name}: card and CPU words differ")
        return lattices_within(os.path.join(dc, ark), os.path.join(dp, ark),
                               name, CLI_LAT_ATOL)
    if kind == "rescored":
        return lattices_within(os.path.join(dc, ark), os.path.join(dp, ark),
                               name, {k: 0.1 * float(b.max()) for k, b in
                                      fft.items()}, LAT_TEXT_REL)
    if kind in ("train", "ng", "priors", "shrink", "shapes", "lstm"):
        return nnet_files_close(kind, dc, dp, out, name)
    if kind == "printed":
        a, b = out["card"][0].splitlines(), out["cpu"][0].splitlines()
        if len(a) != len(b) or not a:
            raise AssertionError(f"{name}: different output")
        worst = 0.0
        for x, y in zip(a, b):
            nx, ny = _printed_numbers(x), _printed_numbers(y)
            if len(nx) != len(ny) or not np.allclose(nx, ny, rtol=0,
                                                     atol=PRINTED_ATOL):
                raise AssertionError(f"{name}: {x!r} vs {y!r}")
            worst = max([worst] + [abs(u - v) for u, v in zip(nx, ny)])
        return worst
    if kind in ("npz", "accs", "eigh", "ubm", "post", "em", "lr"):
        if _cli_files(dc) != _cli_files(dp) or out["card"][0] != \
                out["cpu"][0]:
            raise AssertionError(f"{name}: different files or output")
        rel = {"npz": 0.0, "accs": CLI_ACC_REL, "eigh": CLI_EIGH_REL,
               "ubm": CLI_UBM_REL, "post": CLI_POST_REL, "em": CLI_EM_REL,
               "lr": CLI_LR_REL}[kind]
        return max(npz_rel(os.path.join(dc, f), os.path.join(dp, f), rel,
                           name, (fft or {}).get(f))
                   for f in _cli_files(dc))
    got = list(read_ark(os.path.join(dc, ark)))
    want = list(read_ark(os.path.join(dp, ark)))
    if [k for k, _ in got] != [k for k, _ in want] or not want:
        raise AssertionError(f"{name}: keys differ")
    worst = 0.0
    for (k, g), (_k2, w) in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: shapes differ")
        worst = max(worst, _cli_close(kind, g, w,
                                      None if fft is None else fft[k]))
    return worst


def _printed_numbers(line: str) -> list:
    out = []
    for t in line.replace("(", " ").replace(")", " ").replace(
            ";", " ").split():
        try:
            out.append(float(t))
        except ValueError:
            pass
    return out


def nnet_files_close(kind: str, dc: str, dp: str, out: dict,
                     name: str) -> float:
    """The files of a network command, card (dc) vs CPU (dp), by kind:
    "train" each float array within TRAIN_LIMITS["f32"] of its largest
    value, "ng" within TRAIN_LIMITS["ng_sgd"], "priors" the priors within
    CLI_PRIORS_BOUND and the rest equal, "shrink" the output layer within
    CLI_SHRINK_REL and each hidden array a scalar multiple (within the
    same) of the CPU's, "shapes" the same members, shapes and dtypes, all
    finite, "lstm" the pickled LSTM params within TRAIN_LIMITS["f32"].
    -> the worst relative difference."""
    import pickle
    files = _cli_files(dc)
    if files != _cli_files(dp) or not files:
        raise AssertionError(f"{name}: different files")
    worst = 0.0
    for f in files:
        a, b = os.path.join(dc, f), os.path.join(dp, f)
        if kind in ("train", "ng", "priors"):
            rel = {"train": TRAIN_LIMITS["f32"][0],
                   "ng": TRAIN_LIMITS["ng_sgd"][0], "priors": 0.0}[kind]
            bound = None
            if kind == "priors":
                bound = {"priors": np.full(np.load(b)["priors"].shape,
                                           CLI_PRIORS_BOUND)}
            worst = max(worst, npz_rel(a, b, rel, name, bound))
            continue
        za, zb = np.load(a), np.load(b)
        if sorted(za.files) != sorted(zb.files):
            raise AssertionError(f"{name}: {f} members differ")
        if kind == "lstm":
            x, y = (pickle.loads(z["__host__"].tobytes()) for z in (za, zb))
            if x[:4] != y[:4]:
                raise AssertionError(f"{name}: LSTM headers differ")
            pairs = list(zip(_flat_leaves(x[4]), _flat_leaves(y[4])))
        else:
            pairs = [(za[k], zb[k]) for k in za.files]
        for k, (x, y) in zip(za.files if kind != "lstm" else
                             range(len(pairs)), pairs):
            if x.shape != y.shape or x.dtype != y.dtype or (
                    x.dtype.kind == "f" and not np.isfinite(x).all()):
                raise AssertionError(f"{name}: {f}[{k}] differs")
            if kind == "shapes" or x.dtype.kind != "f":
                continue
            scale = max(float(np.abs(y).max(initial=0.0)), 1e-30)
            if kind == "shrink" and str(k).startswith("layer"):
                c = float(np.vdot(x, y) / max(np.vdot(y, y), 1e-300))
                x = x / c
            d = float(np.abs(x.astype(np.float64) - y).max(
                initial=0.0)) / scale
            lim = CLI_SHRINK_REL if kind == "shrink" else \
                TRAIN_LIMITS["f32"][0]
            if d > lim:
                raise AssertionError(f"{name}: {f}[{k}] {d:.3e} of its "
                                     f"largest value > {lim}")
            worst = max(worst, d)
    return worst


def _flat_leaves(tree) -> list:
    """A nested dict / list tree's arrays in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat_leaves(v)]
    return [np.asarray(tree)]


def _num_gauss(z) -> int:
    """A GMM system file's gaussian count."""
    return sum(z[f"pdf{i}_weights"].shape[0]
               for i in range(int(z["num_pdfs"])))


def npz_rel(a: str, b: str, rel: float, name: str,
            bound: dict | None = None) -> float:
    """Two `.npz` files of one command: the same members, integer arrays
    and pickled host payloads (`host_equal`) equal, every float array
    within `rel` of its largest finite magnitude (its infinities equal)
    plus, for a member in `bound`, that array of elementwise bounds. ->
    the worst difference over the largest magnitude."""
    from kaldi_tpu_torch.io.model_io import _loads
    za, zb = np.load(a), np.load(b)
    if sorted(za.files) != sorted(zb.files):
        raise AssertionError(f"{name}: {os.path.basename(a)} members differ")
    worst = 0.0
    for k in za.files:
        x, y = za[k], zb[k]
        why = ""
        if k == "__host__":
            ok = host_equal(_loads(x.tobytes()), _loads(y.tobytes()))
        elif x.dtype != y.dtype or x.shape != y.shape:
            ok = False
        elif x.dtype.kind != "f":
            ok = np.array_equal(x, y)
        else:
            fin = np.isfinite(y)
            scale = max(float(np.abs(y[fin]).max(initial=0.0)), 1e-300)
            diff = np.abs(x[fin].astype(np.float64) - y[fin])
            allowed = rel * scale + (np.asarray(bound[k])[fin]
                                     if bound and k in bound else 0.0)
            worst = max(worst, float(diff.max(initial=0.0)) / scale)
            ok = bool((diff <= allowed).all()) and np.array_equal(
                x[~fin], y[~fin])
            allowed = np.broadcast_to(allowed, diff.shape)
            if diff.size and not ok:
                at = int(np.argmax(diff - allowed))
                why = (f": {diff.flat[at]:.3e} against "
                       f"{allowed.flat[at]:.3e} allowed, "
                       f"{float(diff.max()) / scale:.3e} of the largest "
                       f"value {scale:.3e}")
        if not ok:
            raise AssertionError(f"{name}: {os.path.basename(a)}[{k}] "
                                 f"differs (limit {rel}){why}")
    return worst


def accs_posterior_bound(model: str, feats: dict, entries: dict,
                         card: str) -> dict:
    """The bound that the gaussian loglikes' card-vs-CPU difference sets on
    GMM accumulators (`posterior_bound` per utterance, as the ladder's and
    the adaptation phases hold posterior-fed statistics): `entries` {utt:
    (frames [N], pdfs [N], weights [N])}, the (frame, pdf, weight) triples
    accumulated -> {accumulator file member: bound array} for each pdf's
    occupancies, first and second moments."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    am_cpu = load_gmm_system(model, device="cpu").am
    am_card = load_gmm_system(model, device=card).am
    seg = am_cpu.pack()[1]
    occ = np.zeros(len(seg))
    m1 = np.zeros((len(seg), am_cpu.dim))
    m2 = np.zeros_like(m1)
    for utt, (frames, pdfs, w) in entries.items():
        x = np.asarray(feats[utt], np.float32)[frames]
        b = posterior_bound(am_cpu, am_card, x, pdfs)["bound"] \
            * np.abs(np.asarray(w, np.float64))[:, None]
        xa = np.abs(x.astype(np.float64))
        occ += b.sum(axis=0)
        m1 += b.T @ xa
        m2 += b.T @ (xa * xa)
    out = {}
    for j in range(am_cpu.num_pdfs):
        g = seg == j
        out.update({f"acc{j}_occ": occ[g], f"acc{j}_mean": m1[g],
                    f"acc{j}_var": m2[g]})
    return out


def _ali_entries(rspecifier: str, tm) -> dict:
    """An alignment archive's (frame, pdf, weight 1) triples per
    utterance."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    return {u: (np.arange(len(a)), tm.id2pdf_array[a], np.ones(len(a)))
            for u, a in open_rspecifier(rspecifier)}


def _post_entries(path: str, tm, sign: int = 0) -> dict:
    """A text posterior file's (frame, pdf, weight) triples per utterance;
    with sign 1 or -1 only the weights of that sign, as their magnitude
    (gmm-acc-stats2's numerator and denominator)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    out = {}
    for utt, post in read_post_ark(path):
        rows = [(t, tm.transition_id_to_pdf(int(tid)), abs(w))
                for t, frame in enumerate(post) for tid, w in frame
                if sign == 0 or w * sign > 0]
        if rows:
            out[utt] = tuple(np.array(c) for c in zip(*rows))
    return out


def cli_acc_bounds(P, name: str, card: str) -> dict:
    """{output file: accs_posterior_bound} of CLI_CASES' accumulating
    cases on cli_gmm_inputs' model, features and alignments."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = P("gmm", "mono.npz")
    tm = load_gmm_system(model, device="cpu").trans_model
    feats = dict(open_rspecifier(f"ark:{P('gmm', 'feats.ark')}"))
    if name == "gmm-acc-stats-ali":
        files = {"a.npz": _ali_entries(f"ark:{P('gmm', 'ali.ark')}", tm)}
    elif name == "gmm-acc-stats":
        files = {"a.npz": _post_entries(P("gmm", "post.txt"), tm)}
    else:
        files = {f: _post_entries(P("gmm", "signed.txt"), tm, s)
                 for f, s in (("n.npz", 1), ("d.npz", -1))}
    return {f: accs_posterior_bound(model, feats, e, card)
            for f, e in files.items()}


def cli_gmm_bounds(P) -> dict:
    """{utt: CLI_LL_REL of each loglike's GEMM terms} for
    gmm-compute-likes on cli_gmm_inputs' model and features."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    am = load_gmm_system(P("gmm", "mono.npz"), device="cpu").am
    return {k: CLI_LL_REL * gmm_term_scale(am, v)
            for k, v in open_rspecifier(f"ark:{P('gmm', 'feats.ark')}")}


def _cli_sides(card: str, device: bool) -> dict:
    """The extra arguments of each side: the card side takes the default
    device ("cuda" when the card is the card)."""
    on_card = [] if (card == "cuda" or not device) else ["--device", card]
    return {"card": on_card, "cpu": ["--device", "cpu"] if device else []}


def cli_card_vs_cpu(root: str, card: str = "cuda") -> dict:
    """Every subcommand of CLI_CASES in-process, once with the default
    device (the card) and once with --device cpu: host files byte-equal,
    device results within their parity bound. -> {name: (card seconds,
    worst diff)}."""
    from kaldi_tpu_torch import cli
    P = cli_inputs(os.path.join(root, "in"))
    res = {}
    for name, argv, kind, ark in CLI_CASES:
        base = argv(P, "{O}")
        device = base[0] in cli.DEVICE_COMMANDS or cli._ALIASES.get(
            base[0], [""])[0] in cli.DEVICE_COMMANDS
        dirs, out = {}, {}
        for side, extra in _cli_sides(card, device).items():
            dirs[side] = os.path.join(root, name, side)
            os.makedirs(dirs[side], exist_ok=True)
            out[side] = cli_call([a.replace("{O}", dirs[side])
                                  for a in base] + extra)
            if out[side][1] not in (0, 1):
                raise AssertionError(f"{name} ({side}): exit "
                                     f"{out[side][1]}: {out[side][3]}")
        if kind.startswith("a_"):
            res[name] = (out["card"][2], adapt_files_close(
                kind, dirs["card"], dirs["cpu"], out, name, P))
            continue
        fft = None
        if kind in ("spec", "fbank", "mfcc"):
            fft, kind = cli_fft_bounds(P, kind), "feat"
        elif kind in ("gmm", "rescored"):
            fft = cli_gmm_bounds(P)
        elif kind == "accs":
            fft = cli_acc_bounds(P, name, card)
        elif kind == "online":
            fft, kind = online_feature_bounds(P("gmm", "wav.scp"),
                                              float(CLI_SR)), "feat"
        res[name] = (out["card"][2],
                     cli_compare(kind, dirs, out, name, ark, fft))
    return res


def _hyp_words(path: str) -> dict:
    with open(path) as f:
        return {ln.split()[0]: ln.split()[1:] for ln in f if ln.strip()}


def _cli_ok(name: str, r):
    if r[1] != 0:
        raise AssertionError(f"{name}: exit {r[1]}: {r[3][-2000:]}")
    return r


def cli_train_card_vs_cpu(root: str, card: str = "cuda") -> dict:
    """The slice's training, graph and decoding subcommands, card vs CPU:
    the file-driven recipe on each (WER 0 on both paths; train-mono and
    train-tdnn held by outcome: the gaussian count, the words), then on
    the card's files decode-faster, gmm-align, decode-faster-mapped and
    online2 identical on both, nnet-am-compute within 1e-5, mkgraph
    array for array, train-nnet3's round trip, --fused equal to the
    generic pipeline on a delta-free system, and the card probes. ->
    {"seconds": {name: card seconds}, "stages": {stage: seconds}}."""
    from kaldi_tpu_torch.io import model_io
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    sides = _cli_sides(card, True)
    secs: dict = {}
    w = {s: os.path.join(root, f"recipe_{s}") for s in sides}
    rec = {s: _cli_ok(f"recipe-yesno-files ({s})", cli_call(
        ["recipe-yesno-files", w[s]] + sides[s])) for s in sides}
    secs["recipe-yesno-files"] = rec["card"][2]
    stages = {}
    for ln in rec["card"][3].splitlines():
        if "seconds by stage" in ln:
            for part in ln.split("seconds by stage ")[1].split(", "):
                k, v = part.rsplit(" ", 1)
                stages[k] = float(v)
    P = lambda *n: os.path.join(w["card"], *n)               # noqa: E731
    ref = _hyp_words(P("test", "text"))
    for s in sides:
        for hyp in ("hyp_gmm.txt", "hyp_tdnn.txt"):
            if _hyp_words(os.path.join(w[s], hyp)) != ref:
                raise AssertionError(f"recipe ({s}): {hyp} is not WER 0")
    gauss = {s: sum(np.load(os.path.join(w[s], "mono.npz"))[
        f"pdf{i}_weights"].shape[0] for i in range(int(np.load(os.path.join(
            w[s], "mono.npz"))["num_pdfs"]))) for s in sides}
    if gauss["card"] != gauss["cpu"]:
        raise AssertionError(f"train-mono: gaussians {gauss}")

    def both(name, argv, compare):
        """argv on the card side and the CPU side -> compare(card, cpu)."""
        out = {}
        for s in sides:
            d = os.path.join(root, name, s)
            os.makedirs(d, exist_ok=True)
            out[s] = _cli_ok(f"{name} ({s})", cli_call(
                [a.replace("{O}", d) for a in argv] + sides[s]))
            out[s] = (d,) + out[s]
        secs[name] = out["card"][3]
        compare(out["card"], out["cpu"])

    def same_stdout(a, b):
        if a[1] != b[1]:
            raise AssertionError("card and CPU print different words")

    def same_file(n):
        def cmp(a, b):
            if open(os.path.join(a[0], n), "rb").read() != \
                    open(os.path.join(b[0], n), "rb").read():
                raise AssertionError(f"{n}: card != CPU")
        return cmp

    def arks_within(kind):
        def cmp(a, b):
            cli_compare(kind, {"card": a[0], "cpu": b[0]},
                        {"card": a[1:], "cpu": b[1:]}, "ark", "o.ark")
        return cmp

    feats = f"ark:{P('test', 'feats.ark')}"
    for name in ("decode-faster", "gmm-decode-faster", "gmm-decode-simple"):
        both(name, [name, P("mono.npz"), P("hclg.npz"), feats], same_stdout)
    for name in ("gmm-align", "gmm-align-compiled"):
        both(name, [name, P("mono.npz"), P("train", "text"),
                    f"ark:{P('train', 'feats.ark')}", "ark:{O}/ali.ark"],
             same_file("ali.ark"))
    for extra in ([], ["--divide-by-priors"], ["--apply-exp"]):
        both("nnet-am-compute", ["nnet-am-compute", P("tdnn.npz"), feats,
                                 "ark:{O}/o.ark", *extra],
             arks_within("nnet"))
    ll = os.path.join(root, "nnet-am-compute", "cpu", "ll.ark")
    _cli_ok("nnet-am-compute", cli_call([
        "nnet-am-compute", P("tdnn.npz"), feats, f"ark:{ll}",
        "--divide-by-priors", "--device", "cpu"]))
    both("decode-faster-mapped", ["decode-faster-mapped", P("hclg.npz"),
                                  f"ark:{ll}"], same_stdout)
    online = [P("mono.npz"), P("tdnn.npz"), P("hclg.npz"),
              P("test", "wav.scp"), "--sample-frequency", CLI_SR]
    both("online2-wav-nnet2-latgen-faster",
         ["online2-wav-nnet2-latgen-faster", *online], same_stdout)
    t = time.perf_counter()
    mk = os.path.join(root, "mkgraph.npz")
    _cli_ok("mkgraph", cli_call(["mkgraph", P("mono.npz"), P("lm.arpa"),
                                 mk]))
    secs["mkgraph"] = time.perf_counter() - t
    a, b = np.load(mk), np.load(P("hclg.npz"))
    if sorted(a.files) != sorted(b.files) or any(
            not np.array_equal(a[k], b[k]) for k in a.files):
        raise AssertionError("mkgraph: a second build differs")
    # train-nnet3: the card's file reloads to identical loglikes, the CPU's
    # loader computes them within 1e-5; the CPU's run trains too
    x = np.random.RandomState(0).randn(1, 30, 39).astype(np.float32)
    lls = {}
    for s in sides:
        n3 = os.path.join(root, f"nnet3_{s}.npz")
        r = _cli_ok(f"train-nnet3 ({s})", cli_call([
            "train-nnet3", P("mono.npz"), P("train", "text"),
            f"ark:{P('train', 'feats.ark')}", n3, "--num-epochs", "8"]
            + sides[s]))
        if s == "card":
            secs["train-nnet3"] = r[2]
        dev = "cpu" if s == "cpu" else card
        am = model_io.load_am_nnet3(n3, device=dev)
        lls[s] = am.loglikes_np(x)
        if not np.isfinite(lls[s]).all() or lls[s].shape[:2] != (1, 30):
            raise AssertionError(f"train-nnet3 ({s}): loglikes")
        again = os.path.join(root, f"nnet3_{s}_again.npz")
        model_io.save_am_nnet3(again, am)
        if not np.array_equal(model_io.load_am_nnet3(
                again, device=dev).loglikes_np(x), lls[s]):
            raise AssertionError(f"train-nnet3 ({s}): reload differs")
    cpu_ll = model_io.load_am_nnet3(os.path.join(root, "nnet3_card.npz"),
                                    device="cpu").loglikes_np(x)
    _cli_close("nnet", cpu_ll, lls["card"])
    # --fused on a delta-free system trained on the card
    D = lambda n: os.path.join(root, n)                      # noqa: E731
    for argv in (["train-mono", P("lexicon.txt"), P("train", "text"),
                  f"ark:{P('train', 'mfcc.ark')}", D("mono0.npz")],
                 ["train-tdnn", D("mono0.npz"), P("train", "text"),
                  f"ark:{P('train', 'mfcc.ark')}", D("tdnn0.npz")]):
        _cli_ok(argv[0], cli_call(argv + sides["card"]))
    _cli_ok("mkgraph", cli_call(["mkgraph", D("mono0.npz"), P("lm.arpa"),
                                 D("hclg0.npz")]))
    common = ["online2-wav-nnet2-latgen-faster", D("mono0.npz"),
              D("tdnn0.npz"), D("hclg0.npz"), P("test", "wav.scp"),
              "--sample-frequency", CLI_SR, "--delta-order", "0"]
    gen = _cli_ok("online2 generic", cli_call(common + sides["card"]))
    fused = _cli_ok("online2 --fused", cli_call(common + ["--fused"]
                                                + sides["card"]))
    secs["online2-wav-nnet2-latgen-faster --fused"] = fused[2]
    if sorted(gen[0].splitlines()) != sorted(fused[0].splitlines()) or \
            len(gen[0].splitlines()) != 8:
        raise AssertionError("--fused != the generic pipeline")
    import torch
    for name, ok in (("cuda-compiled", bool(torch.version.cuda)),
                     ("cuda-gpu-available", torch.cuda.is_available())):
        r = cli_call([name])
        want = 0 if card == "cuda" else int(not ok)
        if r[1] != want:
            raise AssertionError(f"{name}: exit {r[1]}, want {want}")
        secs[name] = r[2]
    return {"seconds": secs, "stages": stages, "fused": fused[0]}


def build_scratch() -> str:
    """-> a new directory under build/ (gitignored) for a phase's files."""
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))


def phase_cli_small() -> None:
    """Phase 35: every device subcommand of the CLI's five slices
    and the first slice's host ones on small inputs on the card and with
    --device cpu (host files byte-equal, device results within their
    parity bound), the file-driven yesno recipe on
    the card, --fused against the generic pipeline, train-nnet3's round
    trip and the card probes; qaffine must not launch."""
    import shutil
    from kaldi_tpu_torch.nnet import quantized as q
    q.launches = 0
    root = build_scratch()
    try:
        res = cli_card_vs_cpu(os.path.join(root, "cases"))
        tr = cli_train_card_vs_cpu(os.path.join(root, "train"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if q.launches:
        raise AssertionError(f"qaffine launched {q.launches} times")
    dev = {n: r for n, r in res.items() if r[1]}
    log(f"  {len(res)} subcommand cases card (default device) vs "
        f"--device cpu: host files byte-equal, device results within "
        f"bound (worst diffs {', '.join(f'{n} {r[1]:.2e}' for n, r in dev.items())}); "
        f"card seconds {', '.join(f'{n} {r[0]:.3f}' for n, r in res.items())}")
    log(f"  training and decoding, card vs CPU: recipe-yesno-files WER 0 on "
        f"the GMM and the streaming-TDNN paths on both; decode-faster, "
        f"gmm-align, decode-faster-mapped and online2 identical, "
        f"nnet-am-compute within 1e-5, train-nnet3 round trip, --fused == "
        f"generic, cuda-compiled and cuda-gpu-available exit 0; card "
        f"seconds {', '.join(f'{n} {s:.3f}' for n, s in tr['seconds'].items())}; "
        f"the recipe on the card by stage "
        f"{', '.join(f'{n} {s:.3f}' for n, s in tr['stages'].items())}")


def phase_cli_bench(tg, sl: dict, tr: dict, tl: dict, card: str) -> dict:
    """Phase 36: the bench decode driven through files in Kaldi's shape —
    bench.py's 8 test waves as wav files, compute-fbank-feats (== the
    port's fbank of what read_wave returns), compute-cmvn-stats and
    apply-cmvn --norm-vars, nnet-am-compute with phase 13's AM,
    decode-faster-mapped on the bench graph through save_hclg at bench.py's
    search options, compute-wer; the words equal a direct CsrBeamDecoder
    decode of the same loglikes ark built with make_decoder's options, its
    overflow 0; the gather launches, qaffine does not."""
    import shutil
    import torch
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchOpts
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.io.model_io import load_hclg, save_am_nnet, save_hclg
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.ops.features import fbank
    from kaldi_tpu_torch.recognize import SERVING_FBANK

    q.launches = 0
    graph = sl["graph"]
    waves = np.asarray(tr["waves"][TRAIN_UTTS:])
    refs = tr["ref"][TRAIN_UTTS:]
    audio = waves.shape[0] * waves.shape[1] / 16000.0
    d = build_scratch()
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    secs = {}

    def run(name, argv):
        r = _cli_ok(name, cli_call(argv))
        secs[name] = r[2]
        return r
    try:
        with open(P("wav.scp"), "w") as f, open(P("ref.txt"), "w") as g:
            for i, w in enumerate(waves):
                write_wave(P(f"test{i}.wav"), w, 16000.0)
                f.write(f"test{i} {P(f'test{i}.wav')}\n")
                g.write(f"test{i} {' '.join(str(x) for x in refs[i])}\n")
        run("compute-fbank-feats", [
            "compute-fbank-feats", P("wav.scp"),
            f"ark,scp:{P('fbank.ark')},{P('fbank.scp')}",
            "--num-mel-bins", "40", "--dither", "0"])
        fb_err = 0.0       # relative: a few f32 roundings of the log-mel
        for i, (k, m) in enumerate(read_ark(P("fbank.ark"))):
            samples = read_wave(P(f"test{i}.wav"))[0][0]
            want = fbank(torch.as_tensor(samples, device="cuda"),
                         SERVING_FBANK).cpu().numpy()
            if k != f"test{i}" or m.shape != want.shape:
                raise AssertionError(f"compute-fbank-feats: {k} {m.shape}")
            fb_err = max(fb_err, float((np.abs(m - want)
                                        / np.maximum(np.abs(want), 1.0))
                                       .max()))
        if not fb_err <= 1e-5:
            raise AssertionError(f"compute-fbank-feats != fbank of "
                                 f"read_wave's samples: {fb_err:.3e}")
        run("compute-cmvn-stats", ["compute-cmvn-stats",
                                   f"ark:{P('fbank.ark')}",
                                   f"ark:{P('cmvn.ark')}"])
        run("apply-cmvn", ["apply-cmvn", f"ark:{P('cmvn.ark')}",
                           f"ark:{P('fbank.ark')}", f"ark:{P('feats.ark')}",
                           "--norm-vars"])
        save_am_nnet(P("final.mdl"), AmNnet(tr["tdnn"]))
        run("nnet-am-compute", ["nnet-am-compute", P("final.mdl"),
                                f"ark:{P('feats.ark')}",
                                f"ark:{P('logpost.ark')}"])
        t = time.perf_counter()
        save_hclg(P("HCLG.npz"), graph)
        save_s = time.perf_counter() - t
        mib = os.path.getsize(P("HCLG.npz")) / 2**20
        search = ["--beam", "13", "--max-active", "7000",
                  "--acoustic-scale", "0.1"]
        tg.launches = 0
        run("decode-faster-mapped", ["decode-faster-mapped", P("HCLG.npz"),
                                     f"ark:{P('logpost.ark')}",
                                     "--transcription-out", P("hyp.txt"),
                                     *search])
        launches = tg.launches
        wer_line = run("compute-wer", ["compute-wer", P("ref.txt"),
                                       P("hyp.txt")])[0].strip()
        hyp = _hyp_words(P("hyp.txt"))
        # the direct decode of the same loglikes ark
        items = list(read_ark(P("logpost.ark")))
        T = max(m.shape[0] for _k, m in items)
        ll = np.full((len(items), T, items[0][1].shape[1]), -1e10,
                     np.float32)
        nf = np.zeros(len(items), np.int32)
        for b, (_k, m) in enumerate(items):
            ll[b, : m.shape[0]] = m
            nf[b] = m.shape[0]
        t = time.perf_counter()
        packed = load_hclg(P("HCLG.npz"))
        load_s = time.perf_counter() - t
        t = time.perf_counter()
        dec = CsrBeamDecoder(packed, CsrBeamOpts(
            beam=13.0, max_active=7000, acoustic_scale=0.1,
            eps_expansions=BeamSearchOpts().eps_expansions), device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        direct = dec.decode(ll, nf)
        ovf = int(np.asarray(dec.last_overflow).sum())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if ovf:
        raise AssertionError(f"direct decode overflow {ovf}")
    for b, (k, _m) in enumerate(items):
        want = [] if direct[b] is None else [str(x) for x in direct[b][0]]
        if hyp.get(k) != want:
            raise AssertionError(f"{k}: decode-faster-mapped != the direct "
                                 f"CsrBeamDecoder decode")
    if launches < 2 * T:
        raise AssertionError(f"{launches} gather launches for {T} frames")
    if q.launches:
        raise AssertionError(f"qaffine launched {q.launches} times")
    # the gather kernel at the shapes this decode gave it
    shapes = csr_gather_shapes(dec, ll.shape[0], ll.shape[2])
    g_times = gather_at_shapes(tg, shapes, "the CLI decode's", 36)
    words = [[int(x) for x in hyp[f"test{i}"]] for i in range(len(waves))]
    rec = tl["rec_words"]
    n_rec = sum(len(x) for x in rec)
    diff = round(wer(rec, words) * n_rec / 100.0)
    rates = ", ".join(f"{n} {s:.3f} s ({audio / s:.1f} audio-sec/s)"
                      for n, s in secs.items())
    log(f"  {len(waves)} test waves ({audio:.0f} s of audio) through the "
        f"port's CLI: {rates}; compute-fbank-feats == fbank of read_wave's "
        f"samples (within {fb_err:.1e} relative, limit 1e-5); HCLG.npz {mib:.1f} MiB, "
        f"save_hclg {save_s:.3f} s, load_hclg {load_s:.3f} s, "
        f"CsrBeamDecoder construction (make_decoder's options) "
        f"{build_s:.3f} s | card: {card}")
    log(f"  decode-faster-mapped at --beam 13 --max-active 7000 "
        f"--acoustic-scale 0.1: == the direct CsrBeamDecoder decode of the "
        f"same loglikes ark (overflow {ovf}); gather launches {launches} "
        f"({launches / T:.2f}/frame over {T} frames), qaffine 0; "
        f"compute-wer: {wer_line}; word errors against phase 34's "
        f"Recognizer-path words (phase 13's AM in bf16, serving CMVN "
        f"std + 1e-5): {diff} of {n_rec}")
    return {"launches": launches, "secs": secs, "save_s": save_s,
            "load_s": load_s, "build_s": build_s, "mib": mib,
            "gather_times": [{
                "shape": list(sh), "ms": t[0], "plain_ms": t[1],
                "library_ms": t[2], "bound_ms": gather_bound_ms(*sh)}
                for sh, t in g_times.items()]}


# phase 37: Kaldi's egs/rm/s5 GMM front half (steps/train_mono.sh ->
# steps/train_deltas.sh -> utils/mkgraph.sh -> decode) through the port's
# CLI over files, at the triphone ladder's width: LADDER's corpus,
# LADDER_MONO's and LADDER_TRI's options, nj = 2 shards
LADDER_CLI_SHARDS = 2
# depth cut for the script's time: train_mono.sh's loop 10 of
# LADDER_MONO's 14 iterations (realigning at each, its ramp to the
# gaussian target unchanged per iteration), train_deltas.sh's
# realignments 5 of LADDER_TRI's 8
LADDER_CLI_MONO_ITERS = 10
LADDER_CLI_TRI_REALIGN = (2, 4, 6, 8, 10)
LADDER_CLI_BOOST = "1.25"          # steps/train_mono.sh's --boost-silence
LADDER_CLI_EST = ["--min-gaussian-occupancy", "3", "--power", "0.25"]
LADDER_CLI_DECODE = ["--beam", "14", "--max-active", "1024",
                     "--acoustic-scale", "0.1"]
LADDER_CLI_KIND = {
    "compute-mfcc-feats": "feature", "add-deltas": "feature",
    "align-equal": "align", "gmm-align": "align", "convert-ali": "align",
    "gmm-acc-stats-ali": "accumulate", "gmm-sum-accs": "accumulate",
    "gmm-init-mono": "estimate", "gmm-boost-silence": "estimate",
    "gmm-est": "estimate", "acc-tree-stats": "tree",
    "sum-tree-stats": "tree", "cluster-phones": "tree",
    "compile-questions": "tree", "build-tree": "tree",
    "gmm-init-model": "tree", "mkgraph": "graph", "arpa2fst": "graph",
    "fsttablecompose": "graph", "fstdeterminizestar": "graph",
    "fstminimizeencoded": "graph", "fstcomposecontext": "graph",
    "make-h-transducer": "graph", "fstrmsymbols": "graph",
    "fstrmepslocal": "graph", "add-self-loops": "graph",
    "fst-pack-graph": "graph", "decode-faster": "decode",
    "compute-wer": "decode"}


def ladder_cli_files(d: str, corpus: dict) -> dict:
    """A data dir per set in Kaldi's layout under d (8 kHz wav files,
    wav.scp, text, utt2spk), the lexicon and the unigram ARPA over the corpus'
    words (phase 20's LM). -> {"train": (utt ids), "test": (...)}."""
    from kaldi_tpu_torch.io.wave import write_wave
    utts = {}
    for part in ("train", "test"):
        os.makedirs(os.path.join(d, part), exist_ok=True)
        with open(os.path.join(d, part, "wav.scp"), "w") as scp, \
                open(os.path.join(d, part, "text"), "w") as text, \
                open(os.path.join(d, part, "utt2spk"), "w") as u2s:
            for u, wave, ws, spk in corpus[part]:
                path = os.path.join(d, part, f"{u}.wav")
                write_wave(path, wave, GMM_SR)
                scp.write(f"{u} {path}\n")
                text.write(f"{u} {' '.join(ws)}\n")
                u2s.write(f"{u} {spk}\n")
        utts[part] = sorted(u for u, _w, _ws, _s in corpus[part])
    V = corpus["words"]
    with open(os.path.join(d, "lexicon.txt"), "w") as f:
        f.write(corpus["lex_text"] + "\n")
    with open(os.path.join(d, "lm.arpa"), "w") as f:
        f.write("\\data\\\nngram 1=%d\n\n\\1-grams:\n%s\n-99\t<s>\n-1\t</s>"
                "\n\n\\end\\\n" % (len(V) + 2, "\n".join(
                    f"-{np.log10(len(V)):.4f}\t{w}" for w in V)))
    return utts


def _tree_stats_rel(a: str, b: str) -> float:
    """Two tree-statistics files: the same events, the largest difference
    of any count, sum or sum of squares over its event's largest
    magnitude."""
    from kaldi_tpu_torch.io.model_io import load_tree_stats
    (x, nx, px), (y, ny, py) = load_tree_stats(a), load_tree_stats(b)
    if (nx, px) != (ny, py) or set(x) != set(y):
        raise AssertionError(f"{a} vs {b}: events differ")
    worst = 0.0
    for ev, s in y.items():
        for u, v in ((x[ev].count, s.count), (x[ev].x, s.x),
                     (x[ev].x2, s.x2)):
            worst = max(worst, float(np.max(np.abs(np.subtract(u, v)))
                                     / max(np.max(np.abs(v)), 1e-300)))
    return worst


def mkgraph_primitives(run, P, mdl: str, tag: str = "") -> str:
    """utils/mkgraph.sh as the CLI's primitives (tests/test_graph_primitives
    _cli.py:21) for the model file P(mdl) and P("lm.arpa"): arpa2fst,
    fsttablecompose, fstdeterminizestar, fstminimizeencoded,
    fstcomposecontext, make-h-transducer, add-self-loops and
    fst-pack-graph, each file under P(tag + name); `run(*argv)` runs one
    command. -> the packed graph's name, P(tag + "graph.npz")."""
    from kaldi_tpu_torch.fst.text_io import save_fst
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    T = lambda n: P(tag + n)                                 # noqa: E731
    lang = load_gmm_system(P(mdl), device="cpu").lang
    save_fst(T("L_disambig.txt"), lang.L_disambig)
    with open(T("phone_disambig.txt"), "w") as f:
        f.writelines(f"{p}\n" for p in lang.disambig_phone_ids)
    lang.words.write(T("words.txt"))
    for argv in (
            ["arpa2fst", P("lm.arpa"), T("words.txt"), T("G.txt")],
            ["fsttablecompose", T("L_disambig.txt"), T("G.txt"),
             T("LG0.txt")],
            ["fstdeterminizestar", "--use-log", T("LG0.txt"), T("LG1.txt")],
            ["fstminimizeencoded", T("LG1.txt"), T("LG.txt")],
            ["fstcomposecontext", T("ilabels.json"), T("LG.txt"),
             T("CLG.txt"), "--context-size", "3", "--central-position",
             "1", "--read-disambig-syms", T("phone_disambig.txt")],
            ["make-h-transducer", T("ilabels.json"), P(mdl), T("Ha.txt"),
             "--disambig-syms-out", T("disambig_tid.txt")],
            ["fsttablecompose", T("Ha.txt"), T("CLG.txt"), T("HCLGa0.txt")],
            ["fstdeterminizestar", "--use-log", T("HCLGa0.txt"),
             T("HCLGa1.txt")],
            ["fstrmsymbols", T("disambig_tid.txt"), T("HCLGa1.txt"),
             T("HCLGa2.txt")],
            ["fstrmepslocal", T("HCLGa2.txt"), T("HCLGa3.txt")],
            ["fstminimizeencoded", T("HCLGa3.txt"), T("HCLGa.txt")],
            ["add-self-loops", P(mdl), T("HCLGa.txt"), T("HCLG.txt"),
             "--self-loop-scale", "0.1"],
            ["fst-pack-graph", P(mdl), T("HCLG.txt"), T("graph.npz")]):
        run(*argv)
    return tag + "graph.npz"


def phase_ladder_cli(card: str) -> dict:
    """Phase 37: LADDER's corpus through the port's CLI in Kaldi's shape,
    every file under a temporary directory in build/:
    compute-mfcc-feats + add-deltas; steps/train_mono.sh as primitives
    (tests/test_gmmbin_cli.py:84: gmm-init-mono, align-equal, then per
    iteration gmm-boost-silence, gmm-align, gmm-acc-stats-ali per shard,
    gmm-sum-accs, gmm-est with a mix-up ramp to LADDER_MONO's gaussians,
    LADDER_CLI_MONO_ITERS iterations);
    steps/train_deltas.sh (tests/test_tree_cli.py:21: acc-tree-stats per
    shard, sum-tree-stats, cluster-phones, compile-questions, build-tree at
    LADDER_TRI's leaves, gmm-init-model, convert-ali, then EM with
    LADDER_TRI's mix-up ramp, realigning at LADDER_CLI_TRI_REALIGN); utils/mkgraph.sh as
    primitives (tests/test_graph_primitives_cli.py:21) beside `mkgraph`;
    decode-faster on the test set and compute-wer. Asserts LADDER_BARS'
    mono and tri bars and tri < mono; the shards' sums equal one unsharded
    accumulation (GMM and tree statistics, 1e-6); one accumulation at
    width with --device cpu within CLI_ACC_REL of the card's plus the
    bound that the gaussian loglikes' difference sets; the
    primitive graph decodes every test utterance to mkgraph's words (its
    states are logged beside mkgraph's: see the note at the graphs' log
    line);
    neither kernel launches (make_decoder picks the dense decoder for the
    triphone graph). -> its results and its directory ("dir"), which
    phase 38 reads and then removes (it is removed here if this phase
    fails)."""
    import shutil
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    corpus = ladder_corpus(**LADDER)
    d = build_scratch()
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    kinds = dict.fromkeys(("feature", "align", "accumulate", "estimate",
                           "tree", "graph", "decode"), 0.0)
    calls = dict.fromkeys(kinds, 0)
    stages, sizes = {}, {}

    def run(*argv):
        r = _cli_ok(argv[0], cli_call(list(argv)))
        kinds[LADDER_CLI_KIND[argv[0]]] += r[2]
        calls[LADDER_CLI_KIND[argv[0]]] += 1
        return r[0]

    def model(name):
        return load_gmm_system(P(name), device="cpu")

    def shards(ali: str):
        alis = dict(open_rspecifier(f"ark:{P(ali)}"))
        keys = np.array_split(np.array(utts["train"]), LADDER_CLI_SHARDS)
        for j, ks in enumerate(keys):
            write_ark(P(f"{ali}.{j + 1}"), {u: alis[u] for u in ks})
        return [f"ark:{P(f'{ali}.{j + 1}')}" for j in range(len(keys))]

    def acc_sum(mdl: str, ali: str, out: str):
        parts = []
        for j, spec in enumerate(shards(ali)):
            parts.append(P(f"{out}.{j + 1}"))
            run("gmm-acc-stats-ali", P(mdl), F, spec, parts[-1])
        run("gmm-sum-accs", P(out), *parts)

    def mix_up(cur: int, inc: int, it: int, opts: dict) -> int:
        return min(opts["totgauss"], cur + inc) \
            if it <= opts["max_iter_inc"] else cur

    def score(mdl: str, graph: str, tag: str):
        hyp = P(f"hyp_{tag}.txt")
        run("decode-faster", P(mdl), P(graph), TF, "--transcription-out",
            hyp, *LADDER_CLI_DECODE)
        line = run("compute-wer", P("test", "text"), hyp).strip()
        return float(line.split()[1]), line, _hyp_words(hyp)

    q.launches = tg.launches = 0          # count this phase's path only
    try:
        t = time.perf_counter()
        utts = ladder_cli_files(d, corpus)
        stages["data"] = time.perf_counter() - t
        t = time.perf_counter()
        for part in ("train", "test"):
            run("compute-mfcc-feats", P(part, "wav.scp"),
                f"ark:{P(part, 'mfcc.ark')}", "--sample-frequency",
                str(int(GMM_SR)), "--dither", "0")
            run("add-deltas", f"ark:{P(part, 'mfcc.ark')}",
                f"ark:{P(part, 'feats.ark')}")
        F, TF = f"ark:{P('train', 'feats.ark')}", \
            f"ark:{P('test', 'feats.ark')}"
        text = P("train", "text")
        stages["features"] = time.perf_counter() - t
        n_frames = sum(v.shape[0] for _k, v in open_rspecifier(F))

        # steps/train_mono.sh
        t = time.perf_counter()
        mo = dict(LADDER_MONO, num_iters=LADDER_CLI_MONO_ITERS)
        run("gmm-init-mono", P("lexicon.txt"), F, P("mono0.npz"))
        m0 = model("mono0.npz")
        sil = str(m0.lang.phones["SIL"])
        cur = m0.am.num_pdfs
        inc = max(1, (mo["totgauss"] - cur) // mo["max_iter_inc"])
        checks = {}
        for it in range(mo["num_iters"]):
            if it == 0:
                run("align-equal", P("mono0.npz"), text, F,
                    f"ark:{P('ali')}")
                mix = []
            else:
                run("gmm-boost-silence", sil, P(f"mono{it}.npz"),
                    P("malign.npz"), "--boost", LADDER_CLI_BOOST)
                run("gmm-align", P("malign.npz"), text, F, f"ark:{P('ali')}")
                cur = mix_up(cur, inc, it, mo)
                mix = ["--mix-up", str(cur)]
            acc_sum(f"mono{it}.npz", "ali", "acc.npz")
            if it == mo["num_iters"] - 1:
                # one unsharded accumulation on the card and on the CPU
                run("gmm-acc-stats-ali", P(f"mono{it}.npz"), F,
                    f"ark:{P('ali')}", P("acc_all.npz"))
                run("gmm-acc-stats-ali", P(f"mono{it}.npz"), F,
                    f"ark:{P('ali')}", P("acc_cpu.npz"), "--device", "cpu")
                checks["mono shards"] = npz_rel(
                    P("acc.npz"), P("acc_all.npz"), 1e-6, "sharded GMM "
                    "statistics")
                checks["card vs cpu"] = npz_rel(
                    P("acc_all.npz"), P("acc_cpu.npz"), CLI_ACC_REL,
                    "card vs CPU accumulation", accs_posterior_bound(
                        P(f"mono{it}.npz"), dict(open_rspecifier(F)),
                        _ali_entries(f"ark:{P('ali')}",
                                     model(f"mono{it}.npz").trans_model),
                        "cuda"))
            run("gmm-est", P(f"mono{it}.npz"), P("acc.npz"),
                P(f"mono{it + 1}.npz"), *LADDER_CLI_EST, *mix)
        mono = f"mono{mo['num_iters']}.npz"
        run("gmm-align", P(mono), text, F, f"ark:{P('ali')}")
        stages["mono"] = time.perf_counter() - t

        # steps/train_deltas.sh
        t = time.perf_counter()
        to = dict(LADDER_TRI, realign_iters=LADDER_CLI_TRI_REALIGN)
        parts = []
        for j, spec in enumerate(shards("ali")):
            parts.append(P(f"ts.npz.{j + 1}"))
            run("acc-tree-stats", P(mono), F, spec, parts[-1])
        run("sum-tree-stats", P("ts.npz"), *parts)
        run("acc-tree-stats", P(mono), F, f"ark:{P('ali')}",
            P("ts_all.npz"))
        checks["tree shards"] = _tree_stats_rel(P("ts.npz"),
                                                P("ts_all.npz"))
        run("cluster-phones", P("ts.npz"), P("questions.txt"))
        run("compile-questions", P("questions.txt"), P("questions.pkl"))
        run("build-tree", P(mono), P("ts.npz"), P("tree.npz"),
            "--questions", P("questions.txt"), "--max-leaves",
            str(to["num_leaves"]))
        run("gmm-init-model", P(mono), P("tree.npz"), P("ts.npz"),
            P("tri0.npz"))
        run("convert-ali", P(mono), P("tri0.npz"), f"ark:{P('ali')}",
            f"ark:{P('triali')}")
        cur = model("tri0.npz").am.num_pdfs
        leaves = cur
        inc = max(1, (to["totgauss"] - cur) // to["max_iter_inc"])
        for it in range(to["num_iters"]):
            if it in to["realign_iters"]:
                run("gmm-align", P(f"tri{it}.npz"), text, F,
                    f"ark:{P('triali')}")
            acc_sum(f"tri{it}.npz", "triali", "tacc.npz")
            cur = mix_up(cur, inc, it + 1, to)
            run("gmm-est", P(f"tri{it}.npz"), P("tacc.npz"),
                P(f"tri{it + 1}.npz"), *LADDER_CLI_EST, "--mix-up",
                str(cur))
        tri = f"tri{to['num_iters']}.npz"
        stages["tri"] = time.perf_counter() - t

        # utils/mkgraph.sh as primitives, beside mkgraph
        t = time.perf_counter()
        run("mkgraph", P(mono), P("lm.arpa"), P("mono_graph.npz"))
        run("mkgraph", P(tri), P("lm.arpa"), P("mk_graph.npz"))
        mkgraph_primitives(run, P, tri)
        stages["graph"] = time.perf_counter() - t
        states = {g: load_hclg(P(g)).num_states
                  for g in ("graph.npz", "mk_graph.npz", "mono_graph.npz")}

        t = time.perf_counter()
        w_mono, l_mono, _h = score(mono, "mono_graph.npz", "mono")
        w_tri, l_tri, h_prim = score(tri, "graph.npz", "tri")
        _w, _l, h_mk = score(tri, "mk_graph.npz", "tri_mk")
        stages["decode"] = time.perf_counter() - t
        gather, qaffine = tg.launches, q.launches
        for n in ("train/feats.ark", "test/feats.ark", mono, tri,
                  "acc.npz", "tacc.npz", "ts.npz", "tree.npz", "HCLG.txt",
                  "graph.npz", "mk_graph.npz"):
            sizes[n] = os.path.getsize(P(n))
        mono_g, tri_g = (model(m).am.total_gauss for m in (mono, tri))
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    total = time.perf_counter() - t0
    n_calls = sum(calls.values())
    log(f"  {len(utts['train'])} training utterances ({n_frames} frames), "
        f"{len(utts['test'])} test, through {n_calls} CLI calls in "
        f"{total:.3f} s | card: {card}")
    log("  seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    log("  seconds by command kind (calls): " + ", ".join(
        f"{k} {v:.3f} ({calls[k]})" for k, v in kinds.items()))
    log("  file sizes (bytes): " + ", ".join(
        f"{k} {v}" for k, v in sizes.items()))
    log(f"  mono: {mono_g} gaussians; {l_mono}")
    log(f"  tri: {leaves} leaves, {tri_g} gaussians; {l_tri}")
    # the text FSTs between the primitives carry weights at OpenFst's 7
    # significant digits (JAX's format, byte for byte), and minimization
    # merges states whose rounded weights agree: the primitive graph may
    # have fewer states than mkgraph's in-memory build, and must decode
    # every test utterance to its words
    log(f"  graphs: primitives {states['graph.npz']} states, mkgraph "
        f"{states['mk_graph.npz']} (mono {states['mono_graph.npz']}); "
        f"the two triphone graphs decode to "
        f"{'the same' if h_prim == h_mk else 'different'} words")
    log(f"  shards' sums vs one accumulation: GMM "
        f"{checks['mono shards']:.3e}, "
        f"tree statistics {checks['tree shards']:.3e} (limit 1e-6); one "
        f"accumulation at width, card vs --device cpu: "
        f"{checks['card vs cpu']:.3e} of each array's largest value "
        f"(limit {CLI_ACC_REL} plus the posteriors' bound); launches: "
        f"gather {gather}, qaffine {qaffine}")
    fails = [msg for msg, ok in (
        (f"mono WER {w_mono} > {LADDER_BARS['mono']}",
         w_mono <= LADDER_BARS["mono"]),
        (f"tri WER {w_tri} > {LADDER_BARS['tri']}",
         w_tri <= LADDER_BARS["tri"]),
        (f"tri WER {w_tri} >= mono {w_mono}", w_tri < w_mono),
        ("sharded tree statistics", checks["tree shards"] <= 1e-6),
        ("primitive graph's words", h_prim == h_mk),
        (f"gather launched {gather} times", gather == 0),
        (f"qaffine launched {qaffine} times", qaffine == 0)) if not ok]
    if fails:
        shutil.rmtree(d, ignore_errors=True)
        raise AssertionError(f"phase 37: {fails}")
    return {"wer": {"mono": w_mono, "tri": w_tri}, "stages": stages,
            "kinds": kinds, "seconds": total, "launches": {
                "gather": gather, "qaffine": qaffine},
            "dir": d, "tri": tri, "frames_test": sum(
                v.shape[0] for _k, v in open_rspecifier(TF))}


# phase 38: Kaldi's egs/rm/s5 decode and scoring back half
# (steps/decode.sh -> local/score.sh -> steps/lmrescore_const_arpa.sh ->
# confidences, ctm and posteriors -> KWS -> steps/decode_fmllr.sh) through
# the port's CLI over phase 37's files: its tri model, primitive-built
# HCLG, G.txt, words.txt, lm.arpa and test set
# the padded beam search of the lattice decodes: at LADDER_CLI_DECODE's
# beam 14 it prunes the right words of 15 of the 40 test utterances (WER
# 20.61 in a CPU rehearsal, 17.98 at beam 16, 7.46 at 20, 3.95 at 24,
# 1.32 at 30; on an H100's tri model 10.09 at 24), where phase 37's
# dense decoder searches every state (1.75 on the rehearsal's model)
LATTICE_CLI_SEARCH = ["--beam", "30", "--max-active", "1024",
                      "--acoustic-scale", "0.1"]
LATTICE_CLI_LMWT = (7, 10, 13)          # local/score.sh's sweep, cut to 3
LATTICE_CLI_WIP = ("0.0", "0.5")
LATTICE_CLI_RECHECK = 8                 # utterances decoded card vs CPU
G_TEXT_REL = 5e-7                       # a weight at 7 significant digits
LATTICE_CLI_KIND = {
    "gmm-latgen-faster": "decode", "latgen-faster-mapped": "decode",
    "gmm-latgen-biglm-faster": "decode", "decode-fmllr": "decode",
    "gmm-compute-likes": "decode", "gmm-align": "decode",
    "lattice-scale": "lattice", "lattice-add-penalty": "lattice",
    "lattice-best-path": "lattice", "lattice-oracle": "lattice",
    "lattice-mbr-decode": "lattice", "lattice-to-ctm-conf": "lattice",
    "compute-wer": "lattice", "arpa-to-const-arpa": "rescore",
    "lattice-lmrescore": "rescore", "lattice-lmrescore-const-arpa": "rescore",
    "gmm-rescore-lattice": "rescore", "lattice-to-post": "post",
    "post-to-weights": "post", "weight-silence-post": "post",
    "post-to-pdf-post": "post", "lattice-to-kws-index": "kws",
    "kws-index-union": "kws", "kws-search": "kws", "compute-atwv": "kws"}


def arpa_text(lm) -> str:
    """An ArpaLm as ARPA text (log10 probabilities and backoffs at 7
    significant digits)."""
    lines = ["\\data\\"] + [f"ngram {k + 1}={len(d)}"
                            for k, d in enumerate(lm.ngrams)]
    for k, d in enumerate(lm.ngrams):
        lines += ["", f"\\{k + 1}-grams:"]
        for ws, (lp, bo) in d.items():
            lines.append(f"{lp / np.log(10):.7g}\t{' '.join(ws)}" + (
                "" if bo is None else f"\t{bo / np.log(10):.7g}"))
    return "\n".join(lines + ["", "\\end\\", ""])


def best_path_abs(lat) -> float:
    """The sum of |graph cost| + |acoustic cost| over the arcs and final
    weight of `lat`'s best path: what a relative rounding of each written
    cost scales."""
    best = {lat.start: (0.0, 0.0)}
    for s in lat.topological_order():
        if s not in best:
            continue
        c, ab = best[s]
        for a in lat.arcs[s]:
            nc = c + a.graph_cost + a.acoustic_cost
            if a.nextstate not in best or nc < best[a.nextstate][0]:
                best[a.nextstate] = (nc, ab + abs(a.graph_cost)
                                     + abs(a.acoustic_cost))
    return min(((best[s][0] + g + ac, best[s][1] + abs(g) + abs(ac))
                for s, (g, ac) in lat.finals.items() if s in best),
               default=(0.0, 0.0))[1]


def phase_lattice_cli(card: str, lc: dict) -> dict:
    """Phase 38: phase 37's files (`lc["dir"]`, which phases 39 and 41
    read and 41 removes; removed here if this phase fails) through the port's
    CLI in the shape of Kaldi's decode and scoring scripts, on the card
    unless a step says otherwise:
    steps/decode.sh (gmm-latgen-faster with --determinize-lattice at
    LATTICE_CLI_SEARCH, as are the other lattice decodes); local/score.sh
    over LATTICE_CLI_LMWT x LATTICE_CLI_WIP (lattice-scale,
    lattice-add-penalty, lattice-best-path, compute-wer) and
    lattice-oracle; steps/lmrescore_const_arpa.sh
    (arpa-to-const-arpa of LADDER_TRIGRAM's trigram and of lm.arpa,
    lattice-lmrescore --lm-scale -1 with G.txt, lattice-lmrescore-const-arpa
    with the unigram, an identity, and with the trigram) and
    gmm-latgen-biglm-faster; the tri model's loglikes (gmm-compute-likes)
    through latgen-faster-mapped into raw lattices, which the frame-level
    tools read (the determinized lattices carry each word's transition ids
    as a string on an arc without an input label); lattice-mbr-decode,
    lattice-to-ctm-conf; lattice-to-post -> post-to-weights and
    weight-silence-post -> post-to-weights -> post-to-pdf-post; KWS over
    the 120 words and KWS_PHRASES phrases with references from a forced
    alignment (gmm-align, words_to_ctm, phase 30's `_kws_refs`):
    lattice-to-kws-index on two shards and unsharded, kws-index-union,
    kws-search, compute-atwv; steps/decode_fmllr.sh (decode-fmllr over
    the 5 test speakers); latgen-faster-mapped on the first
    LATTICE_CLI_RECHECK utterances on the card and with --device cpu;
    gmm-rescore-lattice of the raw lattices. Asserts the best scored WER
    within LADDER_BARS' tri bar and the oracle within it, the identity
    rescoring's best paths (near-ties within its bound counted), the
    union's hits equal to the unsharded index's, posteriors summing to 1
    per frame and silence-weighted ones in [0, 1], card == CPU within
    CLI_LAT_ATOL, gmm-rescore-lattice's best paths (near-ties within the
    loglikes' bound counted) and no kernel launch."""
    import shutil
    from kaldi_tpu_torch.hmm.posterior import post_to_weights, read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    from kaldi_tpu_torch.io.model_io import load_const_arpa, load_gmm_system
    from kaldi_tpu_torch.lat.align import words_to_ctm
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lm.synth import synth_trigram_arpa
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    d = lc["dir"]
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    kinds = dict.fromkeys(("decode", "lattice", "rescore", "post", "kws"),
                          0.0)
    calls = dict.fromkeys(kinds, 0)
    stages, sizes, failed = {}, {}, []

    def run(*argv):
        r = _cli_ok(argv[0], cli_call(list(argv)))
        kinds[LATTICE_CLI_KIND[argv[0]]] += r[2]
        calls[LATTICE_CLI_KIND[argv[0]]] += 1
        return r

    def wer_of(ref: str, hyp: str) -> float:
        return float(run("compute-wer", ref, hyp)[0].split()[1])

    def lats(name):
        return dict(read_lattice_ark(P(name)))

    q.launches = tg.launches = 0          # count this phase's path only
    try:
        tri, graph = P(lc["tri"]), P("graph.npz")
        TF = f"ark:{P('test', 'feats.ark')}"
        model = load_gmm_system(tri, device="cpu")
        words = model.lang.words
        bo = word_id(P("words.txt"), "#0")
        refs = _hyp_words(P("test", "text"))
        with open(P("test", "text_int"), "w") as f:
            f.writelines(f"{u} {' '.join(str(words[w]) for w in ws)}\n"
                         for u, ws in refs.items())

        # steps/decode.sh
        t = time.perf_counter()
        run("gmm-latgen-faster", tri, graph, TF, "--determinize-lattice",
            "--lattice-out", P("det.ark"), "--transcription-out",
            P("hyp_lat.txt"), "--lattice-beam", str(LATTICE_BEAM),
            *LATTICE_CLI_SEARCH)
        w_lat = wer_of(P("test", "text"), P("hyp_lat.txt"))
        hyp_lat, hyp_37 = (_hyp_words(P(h)) for h in ("hyp_lat.txt",
                                                      "hyp_tri.txt"))
        n_other = sum(hyp_lat.get(u) != ws for u, ws in hyp_37.items())
        stages["decode.sh"] = time.perf_counter() - t

        # local/score.sh: the lattices hold acoustic costs at the decode's
        # acoustic scale (0.1), so Kaldi's --inv-acoustic-scale LMWT is
        # --acoustic-scale 1 / (0.1 LMWT) here (steps/score.py's sweep)
        t = time.perf_counter()
        grid = {}
        for lmwt in LATTICE_CLI_LMWT:
            run("lattice-scale", P("det.ark"), P("scaled.ark"),
                "--acoustic-scale", repr(1.0 / (0.1 * lmwt)))
            for wip in LATTICE_CLI_WIP:
                run("lattice-add-penalty", P("scaled.ark"), P("pen.ark"),
                    "--word-ins-penalty", wip)
                with open(P("hyp_int.txt"), "w") as f:
                    f.write(run("lattice-best-path", P("pen.ark"))[0])
                grid[(lmwt, wip)] = wer_of(P("test", "text_int"),
                                           P("hyp_int.txt"))
        (b_lmwt, b_wip), w_best = min(grid.items(), key=lambda kv: kv[1])
        orc = run("lattice-oracle", P("det.ark"), P("test", "text_int"))
        w_orc = float(orc[3].split("%oracle-WER ")[1].split()[0])
        stages["score.sh"] = time.perf_counter() - t

        # steps/lmrescore_const_arpa.sh, then the biglm decode
        t = time.perf_counter()
        V = sorted({ln.split()[0] for ln in open(P("lexicon.txt"))})
        with open(P("tri.arpa"), "w") as f:
            f.write(arpa_text(synth_trigram_arpa(
                V, LADDER_TRIGRAM["n_bigrams"], LADDER_TRIGRAM["n_trigrams"],
                rng=np.random.default_rng(LADDER_TRIGRAM["seed"]))))
        for lm, out in (("tri.arpa", "tri.clm.npz"),
                        ("lm.arpa", "uni.clm.npz")):
            run("arpa-to-const-arpa", P("words.txt"), P(lm), P(out))
        run("lattice-lmrescore", P("det.ark"), P("G.txt"), P("noG.ark"),
            "--lm-scale", "-1", "--backoff-symbol", bo)
        for lm, out in (("uni.clm.npz", "ident.ark"),
                        ("tri.clm.npz", "trigram.ark")):
            run("lattice-lmrescore-const-arpa", tri, P(lm), P("noG.ark"),
                P(out))
        with open(P("hyp_int.txt"), "w") as f:
            f.write(run("lattice-best-path", P("trigram.ark"))[0])
        w_tri = wer_of(P("test", "text_int"), P("hyp_int.txt"))
        uni = load_const_arpa(P("uni.clm.npz"))
        # the largest cost the unigram gives a word or </s> (phase 30 b)
        c_max = max([abs(uni.step(uni.start_state(), words[w])[1])
                     for w in V] + [abs(uni.final_cost(s))
                                    for s in range(uni.num_states)])
        det, ident = lats("det.ark"), lats("ident.ark")
        ties = 0
        for u, lat in det.items():
            old, new = lattice_best_path(lat), lattice_best_path(ident[u])
            n = len(old[0]) + 1
            # phase 30 b's f32 bound, G.txt's 7 digits (the words, </s>
            # and one backoff), two more writes of each graph cost
            bound = n * 2.0 ** -23 * c_max + 64 * F64_EPS * abs(old[2]) \
                + (n + 1) * G_TEXT_REL * c_max \
                + LAT_TEXT_REL * best_path_abs(ident[u])
            gap = abs(new[2] - old[2])
            if list(new[0]) != list(old[0]) and gap <= bound:
                ties += 1
                log(f"  {u}: the identity rescoring's best path differs "
                    f"within its bound (gap {gap:.3e}, bound {bound:.3e})")
            elif gap > bound:
                failed.append(f"identity rescoring moved {u}'s best path "
                              f"by {gap:.3e} > {bound:.3e}")
        run("gmm-latgen-biglm-faster", tri, graph, P("G.txt"),
            P("tri.clm.npz"), TF, "--backoff-symbol", bo,
            "--transcription-out", P("hyp_big.txt"), "--lattice-beam",
            str(LATTICE_BEAM), *LATTICE_CLI_SEARCH)
        w_big = wer_of(P("test", "text"), P("hyp_big.txt"))
        stages["lmrescore_const_arpa.sh"] = time.perf_counter() - t

        # the raw lattices: the tri model's loglikes, then the padded
        # search on them
        t = time.perf_counter()
        run("gmm-compute-likes", tri, TF, f"ark:{P('likes.ark')}")
        run("latgen-faster-mapped", graph, f"ark:{P('likes.ark')}",
            "--lattice-out", P("raw.ark"), "--lattice-beam",
            str(LATTICE_BEAM), *LATTICE_CLI_SEARCH)
        stages["raw lattices"] = time.perf_counter() - t

        # confidences, ctm and posteriors
        t = time.perf_counter()
        mbr = run("lattice-mbr-decode", P("det.ark"), "--acoustic-scale",
                  "1.0")[0]
        with open(P("hyp_mbr.txt"), "w") as f:
            for ln in mbr.splitlines():
                u, *ws = ln.split()
                f.write(" ".join([u] + [w.split(":")[0] for w in ws]) + "\n")
        w_mbr = wer_of(P("test", "text_int"), P("hyp_mbr.txt"))
        ctm = run("lattice-to-ctm-conf", P("raw.ark"), "--acoustic-scale",
                  "1.0")[0].splitlines()
        sil = str(model.lang.phones["SIL"])
        run("lattice-to-post", P("raw.ark"), P("post.txt"),
            "--acoustic-scale", "0.1")
        run("post-to-weights", P("post.txt"), f"ark:{P('pw.ark')}")
        run("weight-silence-post", "0.0", sil, tri, P("post.txt"),
            P("wpost.txt"))
        run("post-to-weights", P("wpost.txt"), f"ark:{P('wpw.ark')}")
        run("post-to-pdf-post", tri, P("wpost.txt"), P("pdf_post.txt"))
        w1 = np.concatenate([v for _k, v in open_rspecifier(
            f"ark:{P('pw.ark')}")])
        ww = np.concatenate([v for _k, v in open_rspecifier(
            f"ark:{P('wpw.ark')}")])
        post_dev = float(np.abs(w1 - 1.0).max())
        if not post_dev <= 1e-4:
            failed.append(f"lattice-to-post's weights {post_dev:.3e} off 1")
        if not (ww.min() >= -1e-4 and ww.max() <= 1 + 1e-4):
            failed.append(f"silence-weighted posteriors in [{ww.min()}, "
                          f"{ww.max()}]")
        if len(w1) != lc["frames_test"]:
            failed.append(f"posteriors over {len(w1)} frames, not "
                          f"{lc['frames_test']}")
        n_pdf = sum(len(p) for _u, p in read_post_ark(P("pdf_post.txt")))
        stages["confidence and posteriors"] = time.perf_counter() - t

        # KWS: references from a forced alignment of the test text
        t = time.perf_counter()
        run("gmm-align", tri, P("test", "text"), TF, f"ark:{P('ali.ark')}")
        lex: dict = {}
        for line in open(P("lexicon.txt")):
            w, *pron = line.split()
            lex.setdefault(words[w], []).append(
                tuple(model.lang.phones[p] for p in pron))
        sil_set = frozenset({model.lang.phones["SIL"]})
        tm = model.trans_model
        ctms = {u: words_to_ctm(np.asarray(a, np.int64),
                                [words[w] for w in refs[u]], tm, lex,
                                sil_set)
                for u, a in open_rspecifier(f"ark:{P('ali.ark')}")}
        phrases = kws_phrases(list(refs.values()), words)
        keywords = [(words[w],) for w in V] + sorted(phrases)
        kwid = {kw: f"KW{i:03d}" for i, kw in enumerate(keywords)}
        with open(P("keywords.txt"), "w") as f:
            f.writelines(f"{kwid[kw]} {' '.join(map(str, kw))}\n"
                         for kw in keywords)
        with open(P("kws_ref.txt"), "w") as f:
            for kw, occ in sorted(_kws_refs(ctms, phrases).items()):
                f.writelines(f"{kwid[kw]} {u} {tb} {te}\n"
                             for u, tb, te in occ)
        raw = lats("raw.ark")
        keys = list(raw)
        half = len(keys) // 2
        for j, part in enumerate((keys[:half], keys[half:])):
            write_lattice_ark(P(f"raw.{j + 1}.ark"),
                              {u: raw[u] for u in part})
            run("lattice-to-kws-index", P(f"raw.{j + 1}.ark"),
                P(f"index.{j + 1}"))
        run("kws-index-union", P("index.union"), P("index.1"), P("index.2"))
        run("lattice-to-kws-index", P("raw.ark"), P("index.all"))
        hits = run("kws-search", P("index.union"), P("keywords.txt"),
                   "--index")[0]
        hits_all = run("kws-search", P("index.all"), P("keywords.txt"),
                       "--index")[0]
        if sorted(hits.splitlines()) != sorted(hits_all.splitlines()):
            failed.append("the union's kws-search hits differ from the "
                          "unsharded index's")
        with open(P("kws_hits.txt"), "w") as f:
            f.write(hits)
        dur = lc["frames_test"] / 100.0
        atwv = run("compute-atwv", repr(dur), P("kws_ref.txt"),
                   P("kws_hits.txt"))[0].splitlines()
        twv = {ln.split()[0]: float(ln.split()[1]) for ln in atwv[:2]}
        stages["kws"] = time.perf_counter() - t

        # steps/decode_fmllr.sh
        t = time.perf_counter()
        run("decode-fmllr", tri, graph, TF, P("test", "utt2spk"),
            "--transcription-out", P("hyp_fmllr.txt"), *LADDER_CLI_DECODE)
        w_fmllr = wer_of(P("test", "text"), P("hyp_fmllr.txt"))
        n_spk = len({ln.split()[1] for ln in open(P("test", "utt2spk"))})
        stages["decode_fmllr.sh"] = time.perf_counter() - t

        # card against CPU; the GMM rescoring of the raw lattices
        t = time.perf_counter()
        likes = list(open_rspecifier(f"ark:{P('likes.ark')}"))
        write_ark(P("likes8.ark"), dict(likes[:LATTICE_CLI_RECHECK]))
        out = {}
        for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            out[side] = run("latgen-faster-mapped", graph,
                            f"ark:{P('likes8.ark')}", "--lattice-out",
                            P(f"lat8_{side}.ark"), "--lattice-beam",
                            str(LATTICE_BEAM), *LATTICE_CLI_SEARCH, *extra)
        if out["card"][0] != out["cpu"][0]:
            failed.append("latgen-faster-mapped: card and CPU words differ")
        lat_diff = lattices_within(P("lat8_card.ark"), P("lat8_cpu.ark"),
                                   "latgen-faster-mapped", CLI_LAT_ATOL)
        run("gmm-rescore-lattice", tri, P("raw.ark"), TF, P("rescored.ark"))
        resc = lats("rescored.ark")
        feats = dict(open_rspecifier(TF))
        r_ties = 0
        for u, lat in raw.items():
            old, new = lattice_best_path(lat), lattice_best_path(resc[u])
            bound = 0.1 * CLI_LL_REL * float(gmm_term_scale(
                model.am, feats[u]).max(axis=-1).sum()) \
                + LAT_TEXT_REL * best_path_abs(resc[u])
            gap = abs(new[2] - old[2])
            if list(new[1]) != list(old[1]) and gap <= bound:
                r_ties += 1
                log(f"  {u}: gmm-rescore-lattice's best path differs "
                    f"within the loglikes' bound (gap {gap:.3e}, bound "
                    f"{bound:.3e})")
            elif gap > bound:
                failed.append(f"gmm-rescore-lattice moved {u}'s best path "
                              f"by {gap:.3e} > {bound:.3e}")
        stages["card vs cpu, rescoring"] = time.perf_counter() - t
        gather, qaffine = tg.launches, q.launches
        arcs = {n: sum(x.num_arcs for x in lats(n).values())
                for n in ("det.ark", "raw.ark", "trigram.ark")}
        for n in ("det.ark", "raw.ark", "trigram.ark", "likes.ark",
                  "tri.arpa", "tri.clm.npz", "uni.clm.npz", "index.union",
                  "post.txt", "pdf_post.txt"):
            sizes[n] = os.path.getsize(P(n))
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    total = time.perf_counter() - t0
    log(f"  {len(det)} test utterances through {sum(calls.values())} CLI "
        f"calls in {total:.3f} s | card: {card}")
    log("  seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    log("  seconds by command kind (calls): " + ", ".join(
        f"{k} {v:.3f} ({calls[k]})" for k, v in kinds.items()))
    log("  lattice arcs: " + ", ".join(f"{k} {v}" for k, v in arcs.items())
        + " | file sizes (bytes): " + ", ".join(
            f"{k} {v}" for k, v in sizes.items()))
    log(f"  gmm-latgen-faster: WER {w_lat:.2f}, {n_other} of {len(hyp_37)} "
        f"utterances in other words than phase 37's decode-faster")
    log("  score.sh (acoustic scale 1/(0.1 lmwt)): " + ", ".join(
        f"lmwt {k[0]} wip {k[1]} {v:.2f}" for k, v in grid.items())
        + f"; best {w_best:.2f} at lmwt {b_lmwt}, wip {b_wip}; oracle "
        f"{w_orc:.2f}")
    log(f"  lmrescore_const_arpa.sh: trigram WER {w_tri:.2f}; the identity "
        f"rescoring keeps every best path ({ties} near-ties); "
        f"gmm-latgen-biglm-faster WER {w_big:.2f}")
    log(f"  MBR WER {w_mbr:.2f}; ctm {len(ctm)} words; posteriors over "
        f"{len(w1)} frames, sum off 1 by at most {post_dev:.3e}, "
        f"silence-weighted in [{ww.min():.6f}, {ww.max():.6f}]; "
        f"{n_pdf} pdf-posterior entries")
    log(f"  KWS: {len(keywords)} keywords ({len(V)} words + {len(phrases)} "
        f"phrases), {len(hits.splitlines())} hits, ATWV {twv['ATWV']:.4f}, "
        f"STWV {twv['STWV']:.4f} over {dur:.2f} s; the two shards' union "
        f"== the unsharded index")
    log(f"  decode-fmllr over {n_spk} speakers: WER {w_fmllr:.2f}")
    log(f"  latgen-faster-mapped on {LATTICE_CLI_RECHECK} utterances, card "
        f"vs --device cpu: costs within {lat_diff:.3e} (limit "
        f"{CLI_LAT_ATOL}); gmm-rescore-lattice keeps every best path "
        f"({r_ties} near-ties); launches: gather {gather}, qaffine "
        f"{qaffine}")
    failed += [msg for msg, ok in (
        (f"best scored WER {w_best} > {LADDER_BARS['tri']}",
         w_best <= LADDER_BARS["tri"]),
        (f"oracle WER {w_orc} > best {w_best}", w_orc <= w_best),
        (f"gather launched {gather} times", gather == 0),
        (f"qaffine launched {qaffine} times", qaffine == 0)) if not ok]
    if failed:
        shutil.rmtree(d, ignore_errors=True)
        raise AssertionError(f"phase 38: {failed}")
    return {"wer": {"latgen": w_lat, "best": w_best, "oracle": w_orc,
                    "trigram": w_tri, "biglm": w_big, "mbr": w_mbr,
                    "fmllr": w_fmllr}, "atwv": twv, "stages": stages,
            "kinds": kinds, "seconds": total, "launches": {
                "gather": gather, "qaffine": qaffine}}


# phase 39: Kaldi's neural recipes (steps/nnet2/train_multisplice_accel2.sh,
# steps/nnet3/train_tdnn.sh, steps/nnet/pretrain_dbn.sh -> train.sh ->
# decode.sh) through the port's CLI over phase 37's files: its tri model,
# alignments of its 200 training utterances, primitive-built HCLG and
# features. Each recipe keeps its training width (LADDER_TDNN,
# LADDER_TDNN3, DBN's 2048 units); depth, epochs and jobs are cut to the
# time limit (NNET_CLI_* and the docstring of phase_nnet_cli)
NNET_CLI_EGS = ["--left-context", "3", "--right-context", "4", "--chunk",
                "8"]                # LADDER_TDNN's splices: context 3 + 4
NNET_CLI_JOBS = 2
NNET_CLI_VALID = "600"              # get_egs2.sh's num_utts_subset ~ 300
# train_multisplice_accel2.sh's outer loop: each iteration trains every
# job from the current model on its archive, then nnet-am-average; the
# learning rate falls geometrically over the iterations from LADDER_NNET's
# initial to its final rate; the last iteration's models go to the
# combination. 4 iterations of 7 epochs (a job sees its archive 28 times)
NNET_CLI_ITERS = 4
NNET_CLI_EPOCHS = "7"
NNET_CLI_MOMENTUM = {"nnet2": "0", "nnet3": "0.9"}  # LADDER_NNET, _NNET3
# pretrain_dbn.sh's first RBMs at its width (2048 units, minibatch 100,
# one epoch each) over splice +-5 and global CMVN; depth cut from 6 to 2
# (each layer's input ark is 200 MB-400 MB of the corpus' frames); both
# at DBN's gaussian-bernoulli rate (the CLI's RBM is gaussian-bernoulli
# at every depth); fine-tuning cut from 8 epochs to 4
NNET_CLI_RBMS = 2
NNET_CLI_DBN_EPOCHS = "4"
# the lattice decodes' lattice beam, cut from decode.sh's 8 to 4 for the
# time limit: only their best paths are scored here, and a lattice beam
# prunes nothing on the best path (at 8 each decode wrote 28-33 MB of
# text lattices on an NVIDIA H100, half the phase's time)
NNET_CLI_LATTICE_BEAM = "4.0"
NNET_CLI_RECON_UTTS = 40      # the RBMs' reconstruction error checked here
NNET_CLI_KIND = {
    "gmm-align": "align", "ali-to-pdf": "align", "analyze-counts": "align",
    "nnet-get-egs": "egs", "nnet3-get-egs": "egs",
    "nnet-shuffle-egs": "egs", "nnet3-shuffle-egs": "egs",
    "nnet-subset-egs": "egs", "nnet3-subset-egs": "egs",
    "nnet-copy-egs": "egs", "nnet3-merge-egs": "egs",
    "nnet-select-egs": "egs", "nnet-am-init": "init", "nnet3-init": "init",
    "nnet-initialize": "init", "nnet-train-simple": "train",
    "nnet3-train": "train", "nnet-am-average": "combine",
    "nnet3-average": "combine", "nnet-combine-fast": "combine",
    "nnet3-combine": "combine", "nnet-compute-prob": "diagnostic",
    "nnet3-compute-prob": "diagnostic", "nnet-show-progress": "diagnostic",
    "nnet3-show-progress": "diagnostic", "nnet-am-info": "diagnostic",
    "nnet3-info": "diagnostic", "nnet-adjust-priors": "priors",
    "nnet3-am-adjust-priors": "priors", "nnet-latgen-faster": "decode",
    "nnet3-latgen-faster": "decode", "nnet3-compute": "decode",
    "decode-faster-mapped": "decode", "latgen-faster-mapped": "decode",
    "lattice-best-path": "decode", "compute-wer": "decode",
    "nnet-forward": "forward", "compute-cmvn-stats": "forward",
    "cmvn-to-nnet": "dbn", "nnet-concat": "dbn",
    "rbm-train-cd1-frmshuff": "dbn", "rbm-convert-to-nnet": "dbn",
    "nnet-train-frmshuff": "train"}


def _rbm_recon(path: str, ark: str, seed: int, dev) -> tuple[float, float]:
    """The mean-field reconstruction error of an RBM file over the frames
    of an ark's first NNET_CLI_RECON_UTTS utterances, and that of the init
    `rbm-train-cd1-frmshuff --seed` starts from: (before, after)."""
    import itertools
    import torch
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    z = np.load(path)
    v = torch.as_tensor(np.concatenate([x for _k, x in itertools.islice(
        read_ark(ark), NNET_CLI_RECON_UTTS)]), device=dev)
    out = []
    for trained in (False, True):
        rbm = Rbm(RbmConfig(*z["W"].shape[::-1]), seed=seed, device=dev)
        if trained:
            rbm.W, rbm.vis_bias, rbm.hid_bias = (
                torch.as_tensor(z[k], device=dev)
                for k in ("W", "vis_bias", "hid_bias"))
        with torch.no_grad():
            r = rbm.reconstruct(rbm.propagate(v))
            out.append(float(torch.mean((r - v) ** 2)))
    return out[0], out[1]


def parallel_sgd(run, P, kind: str, init: str) -> list:
    """train_multisplice_accel2.sh's (and train_tdnn.sh's) outer loop
    through the CLI: NNET_CLI_ITERS iterations, each training every job
    from the current model on its own archive (`job2.j` / `job3.j`) with
    the iteration's slice of the geometric learning-rate decay, then
    averaging them. -> the last iteration's job models and their average
    (what the combination weighs)."""
    train, avg, job = {"nnet2": ("nnet-train-simple", "nnet-am-average",
                                 "job2"),
                       "nnet3": ("nnet3-train", "nnet3-average",
                                 "job3")}[kind]
    lr0, lr1 = LADDER_NNET["initial_lr"], LADDER_NNET["final_lr"]

    def lr(k: int) -> str:
        return repr(lr0 * (lr1 / lr0) ** (k / NNET_CLI_ITERS))
    cur = P(init)
    for it in range(NNET_CLI_ITERS):
        outs = [P(f"{kind}_{it}_{j}.npz") for j in range(NNET_CLI_JOBS)]
        for j, out in enumerate(outs):
            run(train, cur, P(f"{job}.{j}"), out, "--initial-lr", lr(it),
                "--final-lr", lr(it + 1), "--num-epochs", NNET_CLI_EPOCHS,
                "--minibatch-size", str(LADDER_NNET["minibatch_size"]),
                "--momentum", NNET_CLI_MOMENTUM[kind])
        cur = P(f"{kind}_{it}_avg.npz")
        run(avg, cur, *outs)
    return outs + [cur]


def phase_nnet_cli(card: str, lc: dict) -> dict:
    """Phase 39: phase 37's files (`lc["dir"]`, which phase 41 reads and
    then removes; removed here if this phase fails)
    through the port's CLI in the shape of Kaldi's three neural recipes,
    on the card:
    alignments (steps/align_si.sh: gmm-align of the training set with the
    tri model, ali-to-pdf);
    (a) nnet2, steps/nnet2/train_multisplice_accel2.sh as
    tests/test_nnet2_cli.py drives it: nnet-get-egs into 2 archives of the
    39-dim delta features, nnet-shuffle-egs, nnet-subset-egs (validation),
    nnet-copy-egs, nnet-select-egs (one archive per job), nnet-am-init at
    LADDER_TDNN's width, NNET_CLI_ITERS iterations of NNET_CLI_JOBS jobs
    of nnet-train-simple at LADDER_NNET's rates and minibatch, each
    followed by nnet-am-average (`parallel_sgd`), nnet-combine-fast,
    nnet-compute-prob (train and valid), nnet-show-progress,
    nnet-adjust-priors, nnet-am-info, then nnet-latgen-faster ->
    lattice-best-path -> compute-wer;
    (b) nnet3, steps/nnet3/train_tdnn.sh as tests/test_nnet3_cli.py drives
    it: make_tdnn_config at LADDER_TDNN3, nnet3-init, nnet3-get-egs,
    nnet3-shuffle-egs / nnet3-subset-egs / nnet3-merge-egs, the same
    iterations of nnet3-train at LADDER_NNET3 and nnet3-average,
    nnet3-combine,
    nnet3-compute-prob, nnet3-show-progress, nnet3-am-adjust-priors,
    nnet3-info, then nnet3-latgen-faster and nnet3-compute ->
    decode-faster-mapped (the dense decoder) -> compute-wer;
    (c) nnet1, steps/nnet/pretrain_dbn.sh -> train.sh -> decode.sh as
    tests/test_nnet1_cli.py drives it: the feature transform (splice +-5
    of the 13-dim MFCC by nnet-initialize, nnet-forward,
    compute-cmvn-stats, cmvn-to-nnet, nnet-concat), NNET_CLI_RBMS RBMs of
    2048 units (rbm-train-cd1-frmshuff, rbm-convert-to-nnet, the next
    layer's input by nnet-forward), the softmax top (nnet-initialize),
    nnet-concat, nnet-train-frmshuff on the pdf alignments, then
    nnet-forward with the alignment counts' priors -> latgen-faster-mapped
    -> lattice-best-path -> compute-wer. Cuts from the recipes: 2 jobs, a
    job's data is one archive; 4 iterations of 7 epochs; 2 of 6 RBMs, both
    at the gaussian-bernoulli rate; 4 of train.sh's fine-tuning epochs
    (NNET_CLI_*); the lattice beam 4 of decode.sh's 8
    (NNET_CLI_LATTICE_BEAM). The lattice decodes search at
    LATTICE_CLI_SEARCH (the padded decoder at phase 37's beam prunes the
    right words).
    Asserts the nnet2 and nnet3 best-path WERs within LADDER_BARS' tri
    bar, finite loglikes, each RBM's reconstruction error below its
    init's and no kernel launch; the DBN's WER is reported."""
    import shutil
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.nnet3.configs import make_tdnn_config
    from kaldi_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    d = lc["dir"]
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    kinds = dict.fromkeys(sorted(set(NNET_CLI_KIND.values())), 0.0)
    calls = dict.fromkeys(kinds, 0)
    stages, sizes, out = {}, {}, {}

    def run(*argv):
        r = _cli_ok(argv[0], cli_call(list(argv)))
        kinds[NNET_CLI_KIND[argv[0]]] += r[2]
        calls[NNET_CLI_KIND[argv[0]]] += 1
        return r

    def wer_int(hyp_text: str, tag: str) -> float:
        with open(P(f"hyp_{tag}.txt"), "w") as f:
            f.write(hyp_text)
        line = run("compute-wer", P("test", "text_int"),
                   P(f"hyp_{tag}.txt"))[0]
        return float(line.split()[1])

    def egs_bytes(egs: str) -> int:
        return sum(os.path.getsize(os.path.join(P(egs), f))
                   for f in os.listdir(P(egs)))

    def finite(ark: str) -> bool:
        return all(np.isfinite(v).all() for _k, v in read_ark(P(ark)))

    q.launches = tg.launches = 0          # count this phase's path only
    try:
        tri = P(lc["tri"])
        F, TF = f"ark:{P('train', 'feats.ark')}", \
            f"ark:{P('test', 'feats.ark')}"
        model = load_gmm_system(tri, device="cpu")
        pdfs = model.am.num_pdfs
        words = model.lang.words
        with open(P("test", "text_int"), "w") as f:
            f.writelines(f"{u} {' '.join(str(words[w]) for w in ws)}\n"
                         for u, ws in _hyp_words(P("test", "text")).items())

        # steps/align_si.sh
        t = time.perf_counter()
        run("gmm-align", tri, P("train", "text"), F, f"ark:{P('nali')}")
        run("ali-to-pdf", tri, f"ark:{P('nali')}", f"ark:{P('pdf.ark')}")
        run("analyze-counts", f"ark:{P('pdf.ark')}", P("counts.ark"))
        stages["align"] = time.perf_counter() - t

        # (a) steps/nnet2/train_multisplice_accel2.sh
        t = time.perf_counter()
        run("nnet-get-egs", tri, F, f"ark:{P('nali')}", P("egs2"),
            "--num-archives", str(NNET_CLI_JOBS), *NNET_CLI_EGS)
        run("nnet-shuffle-egs", P("egs2"), P("egs2s"), "--num-archives",
            str(NNET_CLI_JOBS), "--seed", "1")
        run("nnet-subset-egs", P("egs2s"), P("valid2"), "--n",
            NNET_CLI_VALID, "--randomize")
        run("nnet-copy-egs", P("egs2s"), P("train2"), "--num-archives",
            "1")
        for j in range(NNET_CLI_JOBS):
            run("nnet-select-egs", P("egs2s"), P(f"job2.{j}"), "--n",
                str(NNET_CLI_JOBS), "--k", str(j))
        sizes["nnet2 egs"] = egs_bytes("egs2")
        stages["nnet2 egs"] = time.perf_counter() - t
        t = time.perf_counter()
        splice = ";".join(",".join(str(o) for o in c)
                          for c in LADDER_TDNN["splice_indexes"])
        run("nnet-am-init", tri, F, P("nn0.npz"),
            f"--splice-indexes={splice}", "--hidden-dim",
            str(LADDER_TDNN["hidden_dim"]), "--pnorm-output-dim",
            str(LADDER_TDNN["pnorm_output_dim"]), "--nonlinearity",
            LADDER_TDNN["nonlinearity"])
        jobs = parallel_sgd(run, P, "nnet2", "nn0.npz")
        run("nnet-combine-fast", P("valid2"), P("nn_comb.npz"), *jobs)
        stages["nnet2 train"] = time.perf_counter() - t
        t = time.perf_counter()
        prob2 = {s: float(run("nnet-compute-prob", P("nn_comb.npz"),
                              P(e))[0].split()[1])
                 for s, e in (("train", "train2"), ("valid", "valid2"))}
        prog2 = run("nnet-show-progress", P("nn0.npz"), P("nn_comb.npz"),
                    P("valid2"))[0].strip().splitlines()[-1]
        run("nnet-adjust-priors", P("nn_comb.npz"), F, P("nn_final.npz"))
        info2 = run("nnet-am-info", P("nn_final.npz"))[0]
        stages["nnet2 diagnostics"] = time.perf_counter() - t
        t = time.perf_counter()
        run("nnet-latgen-faster", tri, P("nn_final.npz"), P("graph.npz"), TF,
            "--lattice-out", P("lat2.ark"), "--lattice-beam",
            NNET_CLI_LATTICE_BEAM, *LATTICE_CLI_SEARCH)
        out["nnet2"] = wer_int(run("lattice-best-path", P("lat2.ark"))[0],
                               "nnet2")
        stages["nnet2 decode"] = time.perf_counter() - t

        # (b) steps/nnet3/train_tdnn.sh
        t = time.perf_counter()
        with open(P("tdnn3.config"), "w") as f:
            f.write(make_tdnn_config(
                39, pdfs, splice_indexes=LADDER_TDNN3["splice_indexes"],
                hidden_dim=LADDER_TDNN3["hidden_dim"],
                nonlinearity="PnormComponent",
                pnorm_output_dim=LADDER_TDNN3["pnorm_output_dim"]))
        run("nnet3-init", P("tdnn3.config"), P("n3_0.npz"))
        run("nnet3-get-egs", tri, F, f"ark:{P('nali')}", P("egs3"),
            "--num-archives", str(NNET_CLI_JOBS), *NNET_CLI_EGS)
        run("nnet3-shuffle-egs", P("egs3"), P("egs3s"), "--num-archives",
            str(NNET_CLI_JOBS), "--seed", "2")
        run("nnet3-subset-egs", P("egs3s"), P("valid3"), "--n",
            NNET_CLI_VALID, "--randomize")
        run("nnet3-merge-egs", P("egs3s"), P("train3"))
        for j in range(NNET_CLI_JOBS):
            run("nnet-select-egs", P("egs3s"), P(f"job3.{j}"), "--n",
                str(NNET_CLI_JOBS), "--k", str(j))
        sizes["nnet3 egs"] = egs_bytes("egs3")
        stages["nnet3 egs"] = time.perf_counter() - t
        t = time.perf_counter()
        jobs = parallel_sgd(run, P, "nnet3", "n3_0.npz")
        run("nnet3-combine", P("valid3"), P("n3_comb.npz"), *jobs)
        stages["nnet3 train"] = time.perf_counter() - t
        t = time.perf_counter()
        prob3 = {s: float(run("nnet3-compute-prob", P("n3_comb.npz"),
                              P(e))[0].split()[1])
                 for s, e in (("train", "train3"), ("valid", "valid3"))}
        prog3 = run("nnet3-show-progress", P("n3_0.npz"), P("n3_comb.npz"),
                    P("valid3"))[0].strip().splitlines()
        run("nnet3-am-adjust-priors", P("n3_comb.npz"), F, P("n3_final.npz"))
        info3 = run("nnet3-info", P("n3_final.npz"))[0]
        stages["nnet3 diagnostics"] = time.perf_counter() - t
        t = time.perf_counter()
        run("nnet3-latgen-faster", tri, P("n3_final.npz"), P("graph.npz"),
            TF, "--lattice-out", P("lat3.ark"), "--lattice-beam",
            NNET_CLI_LATTICE_BEAM, *LATTICE_CLI_SEARCH)
        out["nnet3"] = wer_int(run("lattice-best-path", P("lat3.ark"))[0],
                               "nnet3")
        run("nnet3-compute", P("n3_final.npz"), TF, f"ark:{P('ll3.ark')}",
            "--use-priors")
        out["nnet3 dense"] = wer_int(run(
            "decode-faster-mapped", P("graph.npz"), f"ark:{P('ll3.ark')}",
            *LADDER_CLI_DECODE)[0], "nnet3_dense")
        stages["nnet3 decode"] = time.perf_counter() - t

        # (c) steps/nnet/pretrain_dbn.sh -> train.sh -> decode.sh
        t = time.perf_counter()
        M, TM = f"ark:{P('train', 'mfcc.ark')}", \
            f"ark:{P('test', 'mfcc.ark')}"
        ctx = len(DBN["splice"])
        with open(P("splice.proto"), "w") as f:
            f.write(f"<NnetProto>\n<Splice> <InputDim> 13 <OutputDim> "
                    f"{13 * ctx} <BuildVector> "
                    f"{':'.join(map(str, DBN['splice']))}\n</NnetProto>\n")
        run("nnet-initialize", P("splice.proto"), P("splice.nnet"))
        run("nnet-forward", P("splice.nnet"), M, f"ark:{P('spliced.ark')}",
            "--apply-log")
        run("compute-cmvn-stats", f"ark:{P('spliced.ark')}",
            f"ark:{P('gcmvn.ark')}")
        run("cmvn-to-nnet", f"ark:{P('gcmvn.ark')}", P("cmvn.nnet"))
        run("nnet-concat", P("ft.nnet"), P("splice.nnet"), P("cmvn.nnet"))
        run("nnet-forward", P("ft.nnet"), M, f"ark:{P('l0.ark')}",
            "--apply-log")
        recon, stack = [], [P("ft.nnet")]
        for i in range(1, NNET_CLI_RBMS + 1):
            run("rbm-train-cd1-frmshuff", f"ark:{P(f'l{i - 1}.ark')}",
                P(f"rbm{i}.npz"), "--hidden-dim", str(DBN["hidden"]),
                "--learn-rate", str(DBN["gb_lr"]), "--minibatch-size",
                str(DBN["rbm_mb"]), "--num-epochs", "1", "--seed", str(i))
            recon.append(_rbm_recon(P(f"rbm{i}.npz"), P(f"l{i - 1}.ark"),
                                    i, "cuda"))
            run("rbm-convert-to-nnet", P(f"rbm{i}.npz"), P(f"rbm{i}.nnet"))
            stack.append(P(f"rbm{i}.nnet"))
            if i < NNET_CLI_RBMS:
                run("nnet-concat", P("stack.nnet"), *stack)
                run("nnet-forward", P("stack.nnet"), M,
                    f"ark:{P(f'l{i}.ark')}", "--apply-log")
                sizes[f"l{i}.ark"] = os.path.getsize(P(f"l{i}.ark"))
        stages["dbn pretrain"] = time.perf_counter() - t
        t = time.perf_counter()
        with open(P("top.proto"), "w") as f:
            f.write(f"<NnetProto>\n<AffineTransform> <InputDim> "
                    f"{DBN['hidden']} <OutputDim> {pdfs}\n<Softmax> "
                    f"<InputDim> {pdfs} <OutputDim> {pdfs}\n</NnetProto>\n")
        run("nnet-initialize", P("top.proto"), P("top.nnet"), "--seed", "7")
        run("nnet-concat", P("dbn0.nnet"), *stack[1:], P("top.nnet"))
        ft = run("nnet-train-frmshuff", P("dbn0.nnet"), f"ark:{P('l0.ark')}",
                 f"ark:{P('pdf.ark')}", P("dbn.nnet"), "--learn-rate",
                 str(DBN["ft_lr"]), "--minibatch-size", str(DBN["ft_mb"]),
                 "--num-epochs", NNET_CLI_DBN_EPOCHS)[3].strip()
        stages["dbn finetune"] = time.perf_counter() - t
        t = time.perf_counter()
        run("nnet-concat", P("dbn_final.nnet"), P("ft.nnet"), P("dbn.nnet"))
        run("nnet-forward", P("dbn_final.nnet"), TM, f"ark:{P('lld.ark')}",
            "--apply-log", "--class-frame-counts", P("counts.ark"))
        run("latgen-faster-mapped", P("graph.npz"), f"ark:{P('lld.ark')}",
            "--lattice-out", P("latd.ark"), "--lattice-beam",
            NNET_CLI_LATTICE_BEAM, *LATTICE_CLI_SEARCH)
        out["dbn"] = wer_int(run("lattice-best-path", P("latd.ark"))[0],
                             "dbn")
        stages["dbn decode"] = time.perf_counter() - t
        ok_finite = all(finite(a) for a in ("ll3.ark", "lld.ark"))
        gather, qaffine = tg.launches, q.launches
        for n in ("nn_final.npz", "n3_final.npz", "dbn_final.nnet",
                  "l0.ark", "lat2.ark", "lat3.ark", "latd.ark"):
            sizes[n] = os.path.getsize(P(n))
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    total = time.perf_counter() - t0
    n_calls = sum(calls.values())
    log(f"  nnet2, nnet3 and DBN recipes through {n_calls} CLI calls in "
        f"{total:.3f} s | card: {card}")
    log("  seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    log("  seconds by command kind (calls): " + ", ".join(
        f"{k} {v:.3f} ({calls[k]})" for k, v in kinds.items()))
    log("  file sizes (bytes): " + ", ".join(
        f"{k} {v}" for k, v in sizes.items()))
    log(f"  (a) nnet2 {LADDER_TDNN}, {NNET_CLI_ITERS} iterations of "
        f"{NNET_CLI_JOBS} jobs x {NNET_CLI_EPOCHS} epochs, lr "
        f"{LADDER_NNET['initial_lr']} -> {LADDER_NNET['final_lr']}, "
        f"minibatch {LADDER_NNET['minibatch_size']}: log-prob per frame train "
        f"{prob2['train']:.4f} valid {prob2['valid']:.4f}; {prog2}; "
        f"{info2.splitlines()[5]}; best-path WER {out['nnet2']:.2f}")
    log(f"  (b) nnet3 {LADDER_TDNN3}, the same schedule, momentum "
        f"{NNET_CLI_MOMENTUM['nnet3']}: log-prob per frame train "
        f"{prob3['train']:.4f} valid {prob3['valid']:.4f}; "
        f"{' | '.join(prog3)}; {info3.splitlines()[4]}; best-path WER "
        f"{out['nnet3']:.2f}, nnet3-compute -> decode-faster-mapped WER "
        f"{out['nnet3 dense']:.2f}")
    log(f"  (c) DBN: {NNET_CLI_RBMS} RBMs of {DBN['hidden']} units, "
        f"reconstruction error init -> trained: " + ", ".join(
            f"{a:.5f} -> {b:.5f}" for a, b in recon)
        + f"; fine-tuning ({NNET_CLI_DBN_EPOCHS} epochs): {ft}; WER "
        f"{out['dbn']:.2f} (reported only; phase 24's library DBN: "
        f"PERF.md §7); loglikes finite: {ok_finite}; launches: gather "
        f"{gather}, qaffine {qaffine}")
    fails = [msg for msg, ok in (
        (f"nnet2 WER {out['nnet2']} > {LADDER_BARS['tri']}",
         out["nnet2"] <= LADDER_BARS["tri"]),
        (f"nnet3 WER {out['nnet3']} > {LADDER_BARS['tri']}",
         out["nnet3"] <= LADDER_BARS["tri"]),
        ("loglikes not finite", ok_finite),
        (f"an RBM's reconstruction error did not fall: {recon}",
         all(b < a for a, b in recon)),
        (f"gather launched {gather} times", gather == 0),
        (f"qaffine launched {qaffine} times", qaffine == 0)) if not ok]
    if fails:
        raise AssertionError(f"phase 39: {fails}")
    return {"wer": out, "stages": stages, "kinds": kinds, "seconds": total,
            "recon": recon, "launches": {"gather": gather,
                                         "qaffine": qaffine}}


# phase 41: Kaldi's egs/rm/s5 adaptation and SGMM2 chain
# (steps/train_sat.sh -> decode_fmllr.sh -> train_ubm.sh ->
# train_sgmm2.sh -> decode_sgmm2.sh) through the port's CLI on phase 37's
# files. Depth cut for the script's time (fixed before its first run on a
# card): train_sat.sh's 35 iterations to 6, its fMLLR re-estimation at
# iterations 2, 4, 6, 12 to the initial one and 1, 3, its realignment at
# 10, 20, 30 to 2, 4; train_ubm.sh's 3 iterations as they are;
# train_sgmm2.sh's 25 iterations to 6 on JAX's block schedule (phase 28's:
# v, M, vw, S with c each time), the substates split to 3 per pdf at
# iteration 3, one realignment before iteration 3 (its 5, 10, 15)
ADAPT_CLI_SAT_ITERS = 6
ADAPT_CLI_SAT_FMLLR = (1, 3)
ADAPT_CLI_SAT_REALIGN = (2, 4)
ADAPT_CLI_UBM = dict(num_gauss=400, num_iters=3)
ADAPT_CLI_SGMM_ITERS = 6
ADAPT_CLI_SGMM_FLAGS = ("vc", "Mc", "vwc", "Sc")
ADAPT_CLI_SGMM_REALIGN = 3
ADAPT_CLI_SILENCE = "0.0"      # train_sat.sh's and decode_fmllr.sh's weight
ADAPT_CLI_CPU_UTTS = 20        # the sgmm2-acc-stats held card vs CPU
ADAPT_CLI_SGMM_SLACK = 5.0     # PARITY.md:36: SGMM2 <= SAT + 5 (reported)
ADAPT_CLI_SGMM_BAR = 20.0      # ... and < 20 (asserted)
ADAPT_CLI_KIND = {
    "gmm-align": "align", "ali-to-post": "post", "weight-silence-post":
    "post", "lattice-to-post": "post", "gmm-post-to-gpost": "post",
    "gmm-est-fmllr": "fmllr", "gmm-est-fmllr-gpost": "fmllr",
    "transform-feats": "fmllr", "acc-tree-stats": "tree",
    "sum-tree-stats": "tree", "cluster-phones": "tree",
    "compile-questions": "tree", "build-tree": "tree",
    "gmm-init-model": "tree", "convert-ali": "align",
    "gmm-acc-stats-ali": "accumulate", "gmm-sum-accs": "accumulate",
    "gmm-acc-stats-twofeats": "accumulate", "gmm-est": "estimate",
    "init-ubm": "ubm", "gmm-global-acc-stats": "ubm",
    "gmm-global-sum-accs": "ubm", "gmm-global-est": "ubm",
    "sgmm2-init": "sgmm", "sgmm2-gselect": "sgmm", "sgmm2-acc-stats":
    "sgmm", "sgmm2-sum-accs": "sgmm", "sgmm2-est": "sgmm",
    "sgmm2-align-compiled": "align", "gmm-latgen-faster": "decode",
    "sgmm2-latgen-faster": "decode", "sgmm2-rescore-lattice": "decode",
    "lattice-best-path": "decode", "compute-wer": "decode",
    "sgmm2-info": "sgmm",
    "arpa2fst": "graph", "fsttablecompose": "graph",
    "fstdeterminizestar": "graph", "fstminimizeencoded": "graph",
    "fstcomposecontext": "graph", "make-h-transducer": "graph",
    "fstrmsymbols": "graph", "fstrmepslocal": "graph",
    "add-self-loops": "graph", "fst-pack-graph": "graph"}


def sgmm_scatter_bound(feats: str, post: str) -> np.ndarray:
    """[D, D] the f64 rounding bound of an SGMM2 accumulator's centred
    scatter S_i = sum_t g_ti x x' - (the mean terms), which cancel: 1e-9
    (ADAPT_CLI_REL's f64 bound) of twice sum_t |x_t| |x_t|' over the post
    file's utterances, which bounds either sum's terms for every gaussian
    (sum_i g_ti = 1)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    keep = {ln.split()[0] for ln in open(post) if ln.strip()}
    x = np.abs(np.concatenate([np.asarray(v, np.float64) for k, v in
                               open_rspecifier(feats) if k in keep]))
    return 2 * ADAPT_CLI_REL["a_f64"] * (x.T @ x)


def save_sgmm_cli_witness(P, likes: list, flags: list, ali: list,
                          feats: str, utts: list) -> None:
    """Phase 41's SGMM2 update that lowered the loglike per frame most, in
    `save_sgmm_witness`'s format (tests/test_torch_sgmm_witness.py replays
    it through JAX): the model and the summed statistics before it, its
    flags and the training frames with the pdfs of the alignment that the
    next accumulation used, to chiprun_out/sgmm_cli_witness.pkl."""
    import pickle
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_sgmm2
    from kaldi_tpu_torch.params import sgmm2_to_lists
    falls = [likes[k + 1] - likes[k] for k in range(len(likes) - 1)]
    it = int(np.argmin(falls))
    model = load_sgmm2(P(f"sgmm{it}.npz"), device="cpu").sgmm
    z = np.load(P(f"sg_acc{it}.npz"))
    J = int(z["num_states"])
    tm = load_gmm_system(P(f"sat{ADAPT_CLI_SAT_ITERS}.npz"),
                         device="cpu").trans_model
    rows = dict(open_rspecifier(feats))
    alis = dict(open_rspecifier(f"ark:{P(ali[it + 1])}"))
    x = np.concatenate([rows[u][:len(alis[u])] for u in utts if u in alis])
    pdfs = np.concatenate([tm.id2pdf_array[np.asarray(alis[u], np.int64)]
                           [:len(rows[u])] for u in utts if u in alis])
    a = lambda t: np.asarray(t.cpu() if hasattr(t, "cpu") else t)  # noqa
    v, c = sgmm2_to_lists(model)
    path = os.path.join(ROOT, "chiprun_out", "sgmm_cli_witness.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(dict(
            iter=it, flags=flags[it], likes=likes,
            num_gselect=SGMM_WIDTH["num_gselect"],
            model=dict(Sigma_inv=a(model.Sigma_inv), M=a(model.M),
                       w=a(model.w), V=a(model.V), c=a(model.c),
                       offsets=model.offsets),
            accs=dict(gamma=np.concatenate([z[f"gamma{j}"]
                                            for j in range(J)]),
                      y=np.concatenate([z[f"y{j}"] for j in range(J)]),
                      Y=z["Y"], Q=z["Q"], S_centered=z["S_centered"],
                      tot_like=float(z["tot_like"]),
                      tot_frames=float(z["tot_frames"])),
            x=x.astype(np.float32), pdfs=pdfs, card="phase 41"), f,
            protocol=4)
    log(f"  saved SGMM2 iteration {it} ({flags[it]}: loglike/frame "
        f"{likes[it]:.4f} -> {likes[it + 1]:.4f}) to "
        f"{os.path.relpath(path, ROOT)}")


def phase_adapt_cli(card: str, lc: dict) -> dict:
    """Phase 41: phase 37's files (`lc["dir"]`, removed at the end)
    through the port's CLI in the shape of Kaldi's egs/rm/s5 adaptation
    and SGMM2 chain, on the card:
    (1) steps/train_sat.sh as primitives at the tri widths of phase 37
    (LADDER_TRI's leaves and gaussians): gmm-align with phase 37's tri,
    ali-to-post -> weight-silence-post -> gmm-est-fmllr per speaker ->
    transform-feats; the tree on the fMLLR features (acc-tree-stats per
    shard, sum-tree-stats, cluster-phones, compile-questions, build-tree,
    gmm-init-model, convert-ali); then EM (gmm-acc-stats-ali per shard,
    gmm-sum-accs, gmm-est with the mix-up ramp), realigning at
    ADAPT_CLI_SAT_REALIGN and re-estimating each speaker's fMLLR at
    ADAPT_CLI_SAT_FMLLR (from the speaker-independent features: the
    composed transform; JAX's compose-transforms takes one matrix, not a
    table); the SI model by gmm-acc-stats-twofeats + gmm-est (final.alimdl);
    (2) utils/mkgraph.sh's primitives for the SAT model, then
    steps/decode_fmllr.sh on the test set: the SI pass (gmm-latgen-faster
    with the SI model), lattice-to-post -> weight-silence-post ->
    gmm-post-to-gpost -> gmm-est-fmllr-gpost (JAX's -gpost alias reads
    the silence-weighted posteriors, not gmm-post-to-gpost's pickle) ->
    transform-feats -> the adapted gmm-latgen-faster -> compute-wer;
    (3) steps/train_ubm.sh: init-ubm at 400 gaussians from the SAT model,
    then gmm-global-acc-stats per shard, gmm-global-sum-accs and
    gmm-global-est (ADAPT_CLI_UBM's iterations; the diagonal family: the
    host full-covariance statistics of 400 gaussians over 49k frames take
    minutes per iteration);
    (4) steps/train_sgmm2.sh at phase 28's SGMM_WIDTH on the fMLLR
    features (phn-dim D + 1, spk-dim 0, gselect 15): the SAT model's
    final alignment (final.alimdl's), sgmm2-init, sgmm2-gselect, then per
    iteration sgmm2-acc-stats per shard -> sgmm2-sum-accs -> sgmm2-est on
    ADAPT_CLI_SGMM_FLAGS' schedule with --split-substates to
    SGMM_SUBSTATES_PER_PDF per pdf, one realignment by
    sgmm2-align-compiled;
    (5) steps/decode_sgmm2.sh: sgmm2-latgen-faster on the test set's fMLLR
    features -> compute-wer, sgmm2-rescore-lattice with the decoding model.
    The lattice decodes search at LATTICE_CLI_SEARCH (ROADMAP §3 B 14).
    Asserts SAT <= its SI pass and <= LADDER_BARS' tri bar, SGMM2 <
    ADAPT_CLI_SGMM_BAR, and reports SGMM2 against SAT +
    ADAPT_CLI_SGMM_SLACK (PARITY.md:36, which JAX's SGMM2 misses at width:
    ROADMAP §3 B 8; the update that lowered the loglike most goes to
    chiprun_out/sgmm_cli_witness.pkl for tests/test_torch_sgmm_witness.py);
    the shards' sums equal
    one unsharded accumulation (the SAT statistics on fMLLR features and
    the SGMM2 statistics, 1e-6); one sgmm2-acc-stats at width with
    --device cpu (ADAPT_CLI_CPU_UTTS utterances) within ADAPT_CLI_REL's
    f64 bound of the card's; the rescored lattices keep each best path;
    neither kernel launches. -> its results."""
    import shutil

    import torch
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    d = lc["dir"]
    P = lambda *n: os.path.join(d, *n)                       # noqa: E731
    kinds = dict.fromkeys(sorted(set(ADAPT_CLI_KIND.values())), 0.0)
    calls = dict.fromkeys(kinds, 0)
    stages, sizes, checks, wer, lines = {}, {}, {}, {}, {}

    def run(*argv):
        r = _cli_ok(argv[0], cli_call(list(argv)))
        kinds[ADAPT_CLI_KIND[argv[0]]] += r[2]
        calls[ADAPT_CLI_KIND[argv[0]]] += 1
        return r

    def wer_of(hyp: str, tag: str) -> float:
        line = run("compute-wer", P("test", "text"), P(hyp))[0].strip()
        lines[tag] = line
        return float(line.split()[1])

    def shards(spec: str, name: str) -> list:
        """The training set's rows of ark `spec` in LADDER_CLI_SHARDS
        arks (or post files when `name` ends in .txt)."""
        keys = np.array_split(np.array(utts), LADDER_CLI_SHARDS)
        out = []
        if name.endswith(".txt"):
            with open(spec) as f:
                rows = {ln.split()[0]: ln for ln in f if ln.strip()}
            for j, ks in enumerate(keys):
                out.append(P(f"{name}.{j + 1}"))
                with open(out[-1], "w") as f:
                    f.writelines(rows[u] for u in ks if u in rows)
            return out
        rows = dict(open_rspecifier(spec))
        for j, ks in enumerate(keys):
            write_ark(P(f"{name}.{j + 1}"), {u: rows[u] for u in ks})
            out.append(f"ark:{P(f'{name}.{j + 1}')}")
        return out

    def posts(ali: str, mdl: str, name: str) -> str:
        run("ali-to-post", f"ark:{P(ali)}", P(f"{name}.raw"))
        run("weight-silence-post", ADAPT_CLI_SILENCE, sil, P(mdl),
            P(f"{name}.raw"), P(name))
        return name

    def fmllr(mdl: str, post: str, feats: str, u2s: str, out: str,
              name: str = "gmm-est-fmllr"):
        run(name, P(mdl), feats, P(post), f"ark:{P(out)}", "--utt2spk",
            u2s)

    def transformed(trans: str, feats: str, u2s: str, out: str) -> str:
        run("transform-feats", "--utt2spk", u2s, P(trans), feats,
            f"ark:{P(out)}")
        return f"ark:{P(out)}"

    q.launches = tg.launches = 0          # count this phase's path only
    torch.cuda.reset_peak_memory_stats()
    try:
        F, TF = f"ark:{P('train', 'feats.ark')}", \
            f"ark:{P('test', 'feats.ark')}"
        text, u2s, tu2s = (P("train", "text"), P("train", "utt2spk"),
                           P("test", "utt2spk"))
        tri = lc["tri"]
        utts = [ln.split()[0] for ln in open(text) if ln.strip()]
        sil = str(load_gmm_system(P(tri), device="cpu").lang.phones["SIL"])

        # (1) steps/train_sat.sh
        t = time.perf_counter()
        run("gmm-align", P(tri), text, F, f"ark:{P('sat_ali')}")
        fmllr(tri, posts("sat_ali", tri, "sat_post.txt"), F, u2s,
              "sat_trans.ark")
        SF = transformed("sat_trans.ark", F, u2s, "sat_feats.ark")
        parts = []
        for j, spec in enumerate(shards(f"ark:{P('sat_ali')}", "sat_ali")):
            parts.append(P(f"sat_ts.npz.{j + 1}"))
            run("acc-tree-stats", P(tri), SF, spec, parts[-1])
        run("sum-tree-stats", P("sat_ts.npz"), *parts)
        run("cluster-phones", P("sat_ts.npz"), P("sat_questions.txt"))
        run("compile-questions", P("sat_questions.txt"),
            P("sat_questions.pkl"))
        run("build-tree", P(tri), P("sat_ts.npz"), P("sat_tree.npz"),
            "--questions", P("sat_questions.txt"), "--max-leaves",
            str(LADDER_TRI["num_leaves"]))
        run("gmm-init-model", P(tri), P("sat_tree.npz"), P("sat_ts.npz"),
            P("sat0.npz"))
        run("convert-ali", P(tri), P("sat0.npz"), f"ark:{P('sat_ali')}",
            f"ark:{P('sat_cali')}")
        stages["sat tree"] = time.perf_counter() - t
        t = time.perf_counter()
        cur = load_gmm_system(P("sat0.npz"), device="cpu").am.num_pdfs
        leaves = cur
        inc = max(1, (LADDER_TRI["totgauss"] - cur)
                  // LADDER_TRI["max_iter_inc"])
        for it in range(ADAPT_CLI_SAT_ITERS):
            mdl = f"sat{it}.npz"
            if it in ADAPT_CLI_SAT_REALIGN:
                run("gmm-align", P(mdl), text, SF, f"ark:{P('sat_cali')}")
            if it in ADAPT_CLI_SAT_FMLLR:
                fmllr(mdl, posts("sat_cali", mdl, "sat_post.txt"), F, u2s,
                      "sat_trans.ark")
                SF = transformed("sat_trans.ark", F, u2s, "sat_feats.ark")
            parts = []
            for j, spec in enumerate(shards(f"ark:{P('sat_cali')}",
                                            "sat_cali")):
                parts.append(P(f"sat_acc.npz.{j + 1}"))
                run("gmm-acc-stats-ali", P(mdl), SF, spec, parts[-1])
            run("gmm-sum-accs", P("sat_acc.npz"), *parts)
            if it == ADAPT_CLI_SAT_ITERS - 1:
                run("gmm-acc-stats-ali", P(mdl), SF, f"ark:{P('sat_cali')}",
                    P("sat_acc_all.npz"))
                checks["sat shards"] = npz_rel(
                    P("sat_acc.npz"), P("sat_acc_all.npz"), 1e-6,
                    "sharded SAT statistics")
            cur = min(LADDER_TRI["totgauss"], cur + inc) \
                if it + 1 <= LADDER_TRI["max_iter_inc"] else cur
            run("gmm-est", P(mdl), P("sat_acc.npz"),
                P(f"sat{it + 1}.npz"), *LADDER_CLI_EST, "--mix-up", str(cur))
        sat = f"sat{ADAPT_CLI_SAT_ITERS}.npz"
        # final.alimdl: the SAT model's alignments, statistics of the
        # speaker-independent features
        run("gmm-align", P(sat), text, SF, f"ark:{P('sat_cali')}")
        run("ali-to-post", f"ark:{P('sat_cali')}", P("sat_fpost.txt"))
        run("gmm-acc-stats-twofeats", P(sat), SF, F, P("sat_fpost.txt"),
            P("sat_twoacc.npz"))
        run("gmm-est", P(sat), P("sat_twoacc.npz"), P("sat_si.npz"),
            *LADDER_CLI_EST)
        stages["sat em"] = time.perf_counter() - t

        # (2) the graph, then steps/decode_fmllr.sh
        t = time.perf_counter()
        graph = mkgraph_primitives(run, P, sat, "sat_")
        stages["graph"] = time.perf_counter() - t
        t = time.perf_counter()
        run("gmm-latgen-faster", P("sat_si.npz"), P(graph), TF,
            "--lattice-out", P("si_lat.ark"), "--transcription-out",
            P("hyp_si.txt"), *LATTICE_CLI_SEARCH)
        wer["si"] = wer_of("hyp_si.txt", "si")
        run("lattice-to-post", P("si_lat.ark"), P("si_post.raw"),
            "--acoustic-scale", "0.1")
        run("weight-silence-post", ADAPT_CLI_SILENCE, sil, P("sat_si.npz"),
            P("si_post.raw"), P("si_post.txt"))
        run("gmm-post-to-gpost", P("sat_si.npz"), TF, P("si_post.txt"),
            P("si_gpost.pkl"))
        fmllr(sat, "si_post.txt", TF, tu2s, "test_trans.ark",
              "gmm-est-fmllr-gpost")
        TFA = transformed("test_trans.ark", TF, tu2s, "test_fmllr.ark")
        run("gmm-latgen-faster", P(sat), P(graph), TFA, "--lattice-out",
            P("sat_lat.ark"), "--transcription-out", P("hyp_sat.txt"),
            *LATTICE_CLI_SEARCH)
        wer["sat"] = wer_of("hyp_sat.txt", "sat")
        stages["decode_fmllr"] = time.perf_counter() - t

        # (3) steps/train_ubm.sh
        t = time.perf_counter()
        run("init-ubm", P(sat), P("sat_acc.npz"), P("ubm0.npz"),
            "--ubm-num-gauss", str(ADAPT_CLI_UBM["num_gauss"]),
            "--fullcov-ubm", "false")
        feat_shards = shards(SF, "sat_feats")
        for it in range(ADAPT_CLI_UBM["num_iters"]):
            parts = []
            for j, spec in enumerate(feat_shards):
                parts.append(P(f"ubm_acc.npz.{j + 1}"))
                run("gmm-global-acc-stats", P(f"ubm{it}.npz"), spec,
                    parts[-1])
            run("gmm-global-sum-accs", P("ubm_acc.npz"), *parts)
            run("gmm-global-est", P(f"ubm{it}.npz"), P("ubm_acc.npz"),
                P(f"ubm{it + 1}.npz"))
        ubm = f"ubm{ADAPT_CLI_UBM['num_iters']}.npz"
        stages["ubm"] = time.perf_counter() - t

        # (4) steps/train_sgmm2.sh
        t = time.perf_counter()
        num_pdfs = load_gmm_system(P(sat), device="cpu").am.num_pdfs
        # the SAT model's alignment (train_sgmm2.sh's alignment dir)
        shutil.copyfile(P("sat_fpost.txt"), P("sg_post.txt"))
        dim = next(iter(open_rspecifier(SF)))[1].shape[1]
        run("sgmm2-init", P(sat), P(ubm), P("sgmm0.npz"), "--phn-dim",
            str(dim + 1), "--spk-dim", str(SGMM_WIDTH["spk_dim"]),
            "--num-gselect", str(SGMM_WIDTH["num_gselect"]))
        run("sgmm2-gselect", P("sgmm0.npz"), SF, f"ark:{P('sg_gselect')}",
            "--num-gselect", str(SGMM_WIDTH["num_gselect"]))
        sg_likes, sg_ali = [], []
        for it in range(ADAPT_CLI_SGMM_ITERS):
            mdl = f"sgmm{it}.npz"
            if it == ADAPT_CLI_SGMM_REALIGN:
                run("sgmm2-align-compiled", P(mdl), P(sat), text, SF,
                    f"ark:{P('sg_ali2')}")
                run("ali-to-post", f"ark:{P('sg_ali2')}", P("sg_post.txt"))
            sg_ali.append("sg_ali2" if it >= ADAPT_CLI_SGMM_REALIGN
                          else "sat_cali")
            parts = []
            for j, post in enumerate(shards(P("sg_post.txt"),
                                            "sg_post.txt")):
                parts.append(P(f"sg_acc.npz.{j + 1}"))
                run("sgmm2-acc-stats", P(mdl), P(sat), SF, post, parts[-1])
            run("sgmm2-sum-accs", P("sg_acc.npz"), *parts)
            shutil.copyfile(P("sg_acc.npz"), P(f"sg_acc{it}.npz"))
            z = np.load(P("sg_acc.npz"))
            sg_likes.append(float(z["tot_like"]) / float(z["tot_frames"]))
            if it == ADAPT_CLI_SGMM_ITERS - 1:
                run("sgmm2-acc-stats", P(mdl), P(sat), SF, P("sg_post.txt"),
                    P("sg_acc_all.npz"))
                checks["sgmm shards"] = npz_rel(
                    P("sg_acc.npz"), P("sg_acc_all.npz"), 1e-6,
                    "sharded SGMM2 statistics")
                with open(P("sg_post.txt.1")) as f, \
                        open(P("sg_post_cpu.txt"), "w") as g:
                    g.writelines(ln for k, ln in enumerate(f)
                                 if k < ADAPT_CLI_CPU_UTTS)
                t_cpu = time.perf_counter()
                for side, extra in (("card", []), ("cpu", ["--device",
                                                           "cpu"])):
                    run("sgmm2-acc-stats", P(mdl), P(sat), SF,
                        P("sg_post_cpu.txt"), P(f"sg_acc_{side}.npz"),
                        *extra)
                stages["sgmm card vs cpu"] = time.perf_counter() - t_cpu
                checks["card vs cpu"] = npz_rel(
                    P("sg_acc_card.npz"), P("sg_acc_cpu.npz"),
                    ADAPT_CLI_REL["a_f64"], "card vs CPU SGMM2 statistics",
                    {"S_centered": np.broadcast_to(
                        sgmm_scatter_bound(SF, P("sg_post_cpu.txt")),
                        np.load(P("sg_acc_cpu.npz"))["S_centered"].shape)})
            split = ["--split-substates", str(SGMM_SUBSTATES_PER_PDF
                                              * num_pdfs)] \
                if it == ADAPT_CLI_SGMM_ITERS // 2 else []
            run("sgmm2-est", P(mdl), P("sg_acc.npz"), P(f"sgmm{it + 1}.npz"),
                "--update-flags",
                ADAPT_CLI_SGMM_FLAGS[it % len(ADAPT_CLI_SGMM_FLAGS)], *split)
        sgmm = f"sgmm{ADAPT_CLI_SGMM_ITERS}.npz"
        stages["sgmm"] = time.perf_counter() - t
        flags = [ADAPT_CLI_SGMM_FLAGS[i % len(ADAPT_CLI_SGMM_FLAGS)]
                 for i in range(ADAPT_CLI_SGMM_ITERS)]

        # (5) steps/decode_sgmm2.sh
        t = time.perf_counter()
        run("sgmm2-latgen-faster", P(sgmm), P(sat), P(graph), TFA,
            "--lattice-out", P("sg_lat.ark"), "--transcription-out",
            P("hyp_sgmm.txt"), *LATTICE_CLI_SEARCH)
        wer["sgmm2"] = wer_of("hyp_sgmm.txt", "sgmm2")
        run("sgmm2-rescore-lattice", P(sgmm), P(sat), P("sg_lat.ark"), TFA,
            P("sg_rlat.ark"))
        best = [run("lattice-best-path", P(lat), "--acoustic-scale",
                    "0.1")[0] for lat in ("sg_lat.ark", "sg_rlat.ark")]
        stages["decode_sgmm2"] = time.perf_counter() - t
        gather, qaffine = tg.launches, q.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for n in ("sat_feats.ark", sat, "sat_si.npz", "sat_acc.npz",
                  "sat_trans.ark", "sat_graph.npz", "si_lat.ark",
                  "si_gpost.pkl", ubm, sgmm, "sg_acc.npz", "sg_lat.ark"):
            sizes[n] = os.path.getsize(P(n))
        sat_g = load_gmm_system(P(sat), device="cpu").am.total_gauss
        sg_info = run("sgmm2-info", P(sgmm))[0].strip().splitlines()
        sgmm_ok = wer["sgmm2"] <= wer["sat"] + ADAPT_CLI_SGMM_SLACK and \
            wer["sgmm2"] < ADAPT_CLI_SGMM_BAR
        save_sgmm_cli_witness(P, sg_likes, flags, sg_ali, SF, utts)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    total = time.perf_counter() - t0
    n_calls = sum(calls.values())
    log(f"  SAT, decode_fmllr, UBM, SGMM2 and decode_sgmm2 through "
        f"{n_calls} CLI calls in {total:.3f} s | card: {card}")
    log("  seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    log("  seconds by command kind (calls): " + ", ".join(
        f"{k} {v:.3f} ({calls[k]})" for k, v in kinds.items()))
    log("  file sizes (bytes): " + ", ".join(
        f"{k} {v}" for k, v in sizes.items()))
    log(f"  SAT: {leaves} leaves, {sat_g} gaussians, "
        f"{ADAPT_CLI_SAT_ITERS} iterations; SI pass {lines['si']}; "
        f"adapted {lines['sat']}")
    log(f"  SGMM2: {'; '.join(sg_info)}; loglike per frame by iteration "
        f"{', '.join(f'{x:.4f}' for x in sg_likes)} (flags "
        f"{', '.join(flags)}); {lines['sgmm2']}")
    log(f"  PARITY.md:36 at width: SGMM2 {wer['sgmm2']:.2f} against SAT "
        f"{wer['sat']:.2f} + {ADAPT_CLI_SGMM_SLACK} "
        f"({'met' if sgmm_ok else 'missed'}; reported, ROADMAP §3 B 8: "
        f"JAX's own updates lower the SGMM2's loglike at width, phase 28's "
        f"library SGMM2 misses it too), < {ADAPT_CLI_SGMM_BAR} asserted")
    log(f"  shards' sums vs one accumulation: SAT "
        f"{checks['sat shards']:.3e}, SGMM2 {checks['sgmm shards']:.3e} "
        f"(limit 1e-6); sgmm2-acc-stats on {ADAPT_CLI_CPU_UTTS} utterances "
        f"card vs --device cpu {checks['card vs cpu']:.3e} (limit "
        f"{ADAPT_CLI_REL['a_f64']}); rescored best paths "
        f"{'kept' if best[0] == best[1] else 'changed'}; peak "
        f"{peak:.2f} GiB; launches: gather {gather}, qaffine {qaffine}")
    fails = [msg for msg, ok in (
        (f"SAT WER {wer['sat']} > SI {wer['si']}", wer["sat"] <= wer["si"]),
        (f"SAT WER {wer['sat']} > {LADDER_BARS['tri']}",
         wer["sat"] <= LADDER_BARS["tri"]),
        (f"SGMM2 WER {wer['sgmm2']} >= {ADAPT_CLI_SGMM_BAR}",
         wer["sgmm2"] < ADAPT_CLI_SGMM_BAR),
        ("rescored best paths changed", best[0] == best[1]),
        (f"gather launched {gather} times", gather == 0),
        (f"qaffine launched {qaffine} times", qaffine == 0)) if not ok]
    if fails:
        raise AssertionError(f"phase 41: {fails}")
    return {"wer": wer, "stages": stages, "kinds": kinds, "seconds": total,
            "checks": checks, "peak_gib": peak, "launches": {
                "gather": gather, "qaffine": qaffine}}


# the recipe witnesses: each saves a phase's own inputs, replayed through
# JAX on the CPU by tests/test_torch_<name>_witness.py


# phase 42: the multi-device slice (kaldi_tpu_torch/parallel) on the card
PARALLEL_FLAG = "--parallel-rank"
PARALLEL_SEARCH = dict(beam=13.0, max_active=7000, acoustic_scale=0.1,
                       expand_budget=16384, eps_budget=2048)   # phase 7's
PARALLEL_TDNN = dict(feat_dim=40, num_pdfs=2048, hidden_dim=1024,
                     pnorm_output_dim=256, nonlinearity="relu")  # the bench's
PARALLEL_FRONTIER_UTTS = 2     # of the bench's 8 test utterances
PARALLEL_TRAIN_STEPS = 5
# (a) checks equality at these cuts of the bench's shapes (b) runs whole:
# decode_sharded on 2 utterances, the frontier on the first 300 frames of
# one, the server on 4 streams x 2 s
PARALLEL_A_UTTS, PARALLEL_A_FRAMES = 2, 300
PARALLEL_STREAMS, PARALLEL_STREAM_SAMPLES = 4, 32000
PARALLEL_RANK_TIMEOUT_S = 300
# a mesh's f32 train steps against the single card's: both are held to an
# f64 run of the same steps, the mesh's error per leaf within
# PARALLEL_F32_FACTOR times the single card's own plus a floor of 8 f32
# ulps of the leaf's largest entry (a leaf the single run happens to get
# nearly exact), the losses within 1e-5 of the single card's. Summing a
# gradient over ranks adds its terms in another order, which moves a leaf
# as much as the single card's own order moves it from exact arithmetic
# (at the bench's 15,616 frames per step, up to 4.5e-5 of a leaf's largest
# entry after 5 steps, measured on the card: 1e-5 of it was the first
# limit tried).
PARALLEL_F32_FACTOR = 4.0


def parallel_setup() -> dict:
    """The bench's configuration as phases 7 and 13 build it: the 60k-word
    / 1.05M-state HCLG, the relu TDNN (2048 pdfs, random weights from seed
    0) behind `Recognizer` at phase 7's search, the loglikes of the 8 test
    utterances x 10 s (bf16 TDNN), and phase 13's training batch (16 x
    10 s, fbank + CMVN)."""
    import torch
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import fbank_targets, make_corpus
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.ops.features import cmvn, fbank
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import SERVING_FBANK, Recognizer

    graph, _ = make_big_hclg(BigGraphConfig())
    cfg = TdnnConfig(**PARALLEL_TDNN)
    tree = random_tdnn_params(cfg, np.random.default_rng(0))
    rec = Recognizer(Tdnn(cfg).load_jax_params(tree), graph,
                     CsrBeamOpts(**PARALLEL_SEARCH), device="cuda")
    waves, _segs, _refs = make_corpus(graph, 8, 1000,
                                      np.random.default_rng(0), noise=0.25)
    train_waves, segs, _refs = make_corpus(graph, TRAIN_UTTS + TEST_UTTS, 1000,
                                           np.random.default_rng(0),
                                           noise=0.25)
    with torch.no_grad():
        ll = rec.loglikes(waves).float().cpu().numpy()
        feats = cmvn(fbank(torch.as_tensor(train_waves[:TRAIN_UTTS],
                                           device="cuda"), SERVING_FBANK))
    Tf = feats.shape[1]
    tgt = np.stack([fbank_targets(s, Tf) for s in segs[:TRAIN_UTTS]])
    tgt = tgt[:, cfg.left_context:Tf - cfg.right_context]
    return {"cfg": cfg, "tree": tree, "dec": rec.decoder, "waves": waves,
            "ll": ll, "nf": np.full(ll.shape[0], ll.shape[1], np.int32),
            "feats": feats.cpu().numpy(), "tgt": tgt}


def parallel_train(ps: dict, mesh, dtype=None) -> dict:
    """PARALLEL_TRAIN_STEPS steps of phase 13's optimizer from the seeded
    init over phase 13's batch, in f32 (or `dtype`: float64 gives the
    reference that the f32 runs are held to), on `mesh` or on this card
    alone when None. -> losses, params on the host, ms per step (host
    clock around a synchronize)."""
    import torch
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    dtype = dtype or torch.float32
    params = {k: v.to("cuda", dtype) for k, v in
              tdnn_params_from_jax(ps["tree"]).items()}
    tgt = torch.as_tensor(ps["tgt"], device="cuda")
    batch = (torch.as_tensor(ps["feats"], device="cuda", dtype=dtype), tgt,
             torch.ones(tgt.shape, device="cuda", dtype=dtype))
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.02,
                                       max_grad_norm=5.0),
                         PARALLEL_TRAIN_STEPS)
    state = opt.init(params)
    step = make_train_step(Tdnn(ps["cfg"], device="cuda"), opt, mesh=mesh)
    losses, secs = [], []
    for _ in range(PARALLEL_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss, _acc = step(params, state, *batch)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t)
    return {"losses": losses, "ms": 1e3 * float(np.median(secs[1:])),
            "params": {k: v.cpu().numpy() for k, v in params.items()}}


def train_close(name: str, got: dict, single: dict, exact: dict):
    """-> (worst leaf error / its limit, that leaf, worst relative loss
    difference); raises past either limit (see PARALLEL_F32_FACTOR)."""
    worst, leaf = 0.0, ""
    for k, x in exact["params"].items():
        floor = 8 * float(np.finfo(np.float32).eps) * float(np.abs(x).max())
        mine = float(np.abs(got["params"][k] - x).max())
        limit = PARALLEL_F32_FACTOR * float(
            np.abs(single["params"][k] - x).max()) + floor
        if mine / limit >= worst:
            worst, leaf = mine / limit, k
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                   single["losses"]))
    if worst > 1.0 or loss > 1e-5:
        raise AssertionError(f"{name}: leaf {leaf}'s error {worst:.3f} of its "
                             f"limit, losses {loss:.3e} apart (limit 1e-5)")
    return worst, leaf, loss


def timed(fn):
    """(fn(), host seconds) with the card synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def parallel_refs(ps: dict) -> dict:
    """The single-card runs both legs are held to: the CsrBeamDecoder's
    decode of the 8 utterances, the f32 train steps and their f64 twin."""
    import torch
    single, secs = timed(lambda: ps["dec"].decode(ps["ll"], ps["nf"]))
    return {"single": single, "single_s": secs,
            "train": parallel_train(ps, None),
            "exact": parallel_train(ps, None, torch.float64)}


def parallel_leg_nccl(ps: dict, refs: dict, tg, q, card: str) -> dict:
    """Phase 42 (a): one rank over NCCL, mesh (1, 1): decode_sharded,
    decode_frontier_sharded, the mesh train step and the sharded server
    each equal their single-device runs on the card."""
    import torch.distributed as dist
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.serving import FusedStreamingServer
    from kaldi_tpu_torch.parallel import (decode_frontier_sharded,
                                          decode_sharded, make_mesh)
    from kaldi_tpu_torch.recognize import SERVING_FBANK
    dec, U = ps["dec"], PARALLEL_A_UTTS
    ll, nf = ps["ll"][:U], ps["nf"][:U]
    ll1 = np.ascontiguousarray(ps["ll"][:1, :PARALLEL_A_FRAMES])
    nf1 = np.array([PARALLEL_A_FRAMES], np.int32)
    single1 = dec.decode(ll1, nf1)
    am = AmNnet(Tdnn(ps["cfg"]).load_jax_params(ps["tree"]),
                priors=np.random.default_rng(2).dirichlet(
                    np.ones(ps["cfg"].num_pdfs)))
    waves = [w[:PARALLEL_STREAM_SAMPLES]
             for w in ps["waves"][:PARALLEL_STREAMS]]
    kw = dict(n_streams=PARALLEL_STREAMS, chunk_samples=2560, t_max=1024)
    srv_single, _secs = _stream_all(FusedStreamingServer(am, dec,
                                                         SERVING_FBANK, **kw),
                                    waves, [2560] * len(waves))
    mesh = make_mesh(1, 1, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"(a): backend {dist.get_backend()}")
        tg.launches = q.launches = 0       # count the mesh path only
        sharded, sharded_s = timed(lambda: decode_sharded(dec, ll, nf, mesh))
        fs, fs_s = timed(lambda: decode_frontier_sharded(dec, ll1, nf1, mesh))
        srv = FusedStreamingServer(am, dec, SERVING_FBANK, **kw, mesh=mesh)
        srv_mesh, _secs = _stream_all(srv, waves, [2560] * len(waves))
        train = parallel_train(ps, mesh)
        launches, q_launches = tg.launches, q.launches
    finally:
        dist.destroy_process_group()
    _same_results("(a) decode_sharded", sharded, refs["single"][:U],
                  "mesh (1, 1)")
    _same_results("(a) frontier", fs, single1, "mesh (1, 1)")
    _same_results("(a) server", srv_mesh, srv_single, "mesh (1, 1)")
    worst, leaf, losses = train_close("(a) train", train, refs["train"],
                                      refs["exact"])
    frames = PARALLEL_A_FRAMES
    if launches < 2 * frames or q_launches:
        raise AssertionError(f"(a): {launches} gather launches for "
                             f"{frames} frontier frames, qaffine "
                             f"{q_launches}")
    single_ms = 1e3 * refs["single_s"] / ps["ll"].shape[1]
    line = (f"  (a) one rank over NCCL, mesh (1, 1): decode_sharded over {U} "
        f"of the bench's 10 s utterances == CsrBeamDecoder ({sharded_s:.3f} "
        f"s; the single decode of all 8 {refs['single_s']:.3f} s, "
        f"{single_ms:.4f} ms per frame); decode_frontier_sharded on the "
        f"first {frames} frames of one == it, {1e3 * fs_s / frames:.4f} "
        f"ms/frame; the sharded server, "
        f"{PARALLEL_STREAMS} streams x {PARALLEL_STREAM_SAMPLES / 16000:.0f} "
        f"s == the unsharded one; {PARALLEL_TRAIN_STEPS} f32 mesh train "
        f"steps == single (against an f64 run: worst leaf {leaf} at "
        f"{worst:.3f} of its limit; losses {losses:.3e} apart; "
        f"{train['ms']:.3f} vs {refs['train']['ms']:.3f} ms/step); gather "
        f"launches {launches}, qaffine {q_launches} | card: {card}")
    log(line)
    return {"launches": launches, "fs_ms": 1e3 * fs_s / frames,
            "train_ms": train["ms"], "line": line}


def parallel_rank() -> int:
    """Phase 42 (b), one rank (`PARALLEL_FLAG <dir>`, started by
    launch_local): two ranks share the card over gloo with CUDA tensors
    (NCCL refuses two ranks on one card). Reads the inputs the parent
    wrote to <dir>/inputs.npz, writes its results to <dir>/rank.<r>.json
    (rank 0 also its train params, <dir>/params.npz)."""
    import torch
    import torch.distributed as dist
    from kaldi_tpu_torch import cuda_build
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.ops import table_gather as tg
    from kaldi_tpu_torch.parallel import (decode_frontier_sharded,
                                          decode_sharded, init_distributed,
                                          make_mesh)
    from kaldi_tpu_torch.params import random_tdnn_params
    out_dir = sys.argv[sys.argv.index(PARALLEL_FLAG) + 1]
    rank, _world = init_distributed(device="cuda", backend="gloo")
    resolve_device("cuda")
    torch.set_num_threads(2)
    # phase 2 built the kernels: a rank never builds (two would race)
    if not all(os.path.exists(cuda_build.library_path(n))
               for n in cuda_build.sources()):
        raise AssertionError("the kernels are not built (phase 2)")
    graph, _ = make_big_hclg(BigGraphConfig())
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**PARALLEL_SEARCH), device="cuda")
    m21 = make_mesh(2, 1, device="cuda")
    m12 = make_mesh(1, 2, device="cuda")
    # set up while the parent runs (a); measure after it, alone
    go, deadline = os.path.join(out_dir, "go"), time.time() + \
        PARALLEL_RANK_TIMEOUT_S
    while not os.path.exists(go):
        if time.time() > deadline:
            raise TimeoutError("the parent never wrote its go file")
        time.sleep(0.05)
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    ll, nf = inputs["ll"], inputs["nf"]
    cfg = TdnnConfig(**PARALLEL_TDNN)
    ps = {"cfg": cfg, "feats": inputs["feats"], "tgt": inputs["tgt"],
          "tree": random_tdnn_params(cfg, np.random.default_rng(0))}
    U = PARALLEL_FRONTIER_UTTS
    dist.barrier()
    tg.launches = q.launches = 0           # count the mesh path only
    sharded, sharded_s = timed(lambda: decode_sharded(dec, ll, nf, m21))
    fs, fs_s = timed(lambda: decode_frontier_sharded(dec, ll[:U], nf[:U], m12,
                                                     axis="model"))
    res = {"rank": rank, "sharded": sharded, "sharded_s": sharded_s,
           "frontier": fs, "frontier_s": fs_s,
           "overflow": dec.last_overflow.tolist(),
           "gathered_bytes": dec.last_gathered_bytes,
           "rounds": dec.last_exchange_rounds, "frames": int(nf[:U].sum())}
    train = parallel_train(ps, m21)
    res.update(launches=tg.launches, qaffine=q.launches,
               train_ms=train["ms"], losses=train["losses"])
    if rank == 0:
        np.savez(os.path.join(out_dir, "params.npz"), **train["params"])
    with open(os.path.join(out_dir, f"rank.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel_gang(d: str):
    """Start phase 42 (b)'s two ranks on the card over gloo through the
    port's launch_local, in a thread: they build the bench graph and
    decoder while the parent runs (a), then wait for <d>/go. -> the
    future of their exit codes."""
    from concurrent.futures import ThreadPoolExecutor
    from kaldi_tpu_torch.parallel.launch import free_port, launch_local
    ex = ThreadPoolExecutor(1)
    gang = ex.submit(
        launch_local,
        [sys.executable, os.path.abspath(__file__), PARALLEL_FLAG, d], 2,
        os.path.join(d, "logs"), coordinator_port=free_port(),
        timeout=PARALLEL_RANK_TIMEOUT_S)
    ex.shutdown(wait=False)
    return gang


def parallel_leg_gloo(d: str, codes: list, refs: dict, card: str) -> dict:
    """Phase 42 (b), read from the ranks' files in `d`: the
    frontier-sharded decode at D = 2 on 2 utterances, decode_sharded over
    the 8 (4 per rank) and 5 f32 data-parallel train steps, each against
    the single card."""
    if codes != [0, 0]:
        for i in range(2):
            with open(os.path.join(d, "logs", f"worker.{i}.log")) as f:
                log(f.read()[-6000:])
        raise AssertionError(f"(b): rank exit codes {codes}")
    ranks = []
    for i in range(2):
        with open(os.path.join(d, f"rank.{i}.json")) as f:
            ranks.append(json.load(f))
    with np.load(os.path.join(d, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    r0, r1 = ranks
    for key in ("sharded", "frontier", "overflow", "losses"):
        if r0[key] != r1[key]:
            raise AssertionError(f"(b): the ranks' {key} differ")
    U = PARALLEL_FRONTIER_UTTS
    _same_results("(b) decode_sharded", r0["sharded"], refs["single"],
                  "2 ranks")
    _same_results("(b) frontier", r0["frontier"], refs["single"][:U], "D = 2")
    worst, leaf, losses = train_close(
        "(b) train", {"params": params, "losses": r0["losses"]},
        refs["train"], refs["exact"])
    if any(r["qaffine"] for r in ranks) or any(
            r["launches"] < 2 * r["frames"] for r in ranks):
        raise AssertionError(f"(b): launches {[r['launches'] for r in ranks]}"
                             f", qaffine {[r['qaffine'] for r in ranks]}")
    frames = r0["frames"]
    line = (f"  (b) two ranks on the one card over gloo (CUDA tensors), spawned "
        f"by launch_local (set up during (a)): "
        f"decode_frontier_sharded at D = 2 on {U} x 10 s == CsrBeamDecoder on "
        f"the card (words, tids, cost within 1e-2; overflow "
        f"{r0['overflow']}), {r0['rounds']} exchanges, "
        f"{r0['gathered_bytes'] / r0['rounds']:.0f} gathered bytes per frame "
        f"per rank, {1e3 * r0['frontier_s'] / frames:.4f} ms/frame; "
        f"decode_sharded over 8 x 10 s (4 per rank) == the single decode "
        f"({r0['sharded_s']:.3f} s); {PARALLEL_TRAIN_STEPS} f32 "
        f"data-parallel steps of the bench's TDNN on its batch == the single "
        f"card (against an f64 run: worst leaf {leaf} at {worst:.3f} of its "
        f"limit; losses {losses:.3e} apart): {r0['train_ms']:.3f} ms/step; "
        f"gather launches {[r['launches'] for r in ranks]} | card: {card}")
    log(line)
    return {"launches": sum(r["launches"] for r in ranks),
            "gathered_bytes_per_frame": r0["gathered_bytes"] / r0["rounds"],
            "fs_ms": 1e3 * r0["frontier_s"] / frames,
            "train_ms": r0["train_ms"], "line": line}


def phase_parallel(tg, q, card: str) -> dict:
    """Phase 42: (b)'s ranks start and set up, the single-card references
    and (a) run, then (b) measures."""
    import shutil
    d = build_scratch()
    try:
        gang = parallel_gang(d)
        try:
            ps = parallel_setup()
            np.savez(os.path.join(d, "inputs.npz"), ll=ps["ll"], nf=ps["nf"],
                     feats=ps["feats"], tgt=ps["tgt"])
            refs = parallel_refs(ps)
            a = parallel_leg_nccl(ps, refs, tg, q, card)
        finally:
            # the ranks go on (and end) whatever happened above
            open(os.path.join(d, "go"), "w").close()
            codes = gang.result()
        b = parallel_leg_gloo(d, codes, refs, card)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    line = (f"  per frame of the frontier-sharded decode: {a['fs_ms']:.4f} ms on "
        f"one rank, {b['fs_ms']:.4f} ms on two over gloo "
        f"({b['gathered_bytes_per_frame']:.0f} bytes gathered per rank); per "
        f"f32 train step: {refs['train']['ms']:.3f} ms on the card alone, "
        f"{a['train_ms']:.3f} ms on one NCCL rank, {b['train_ms']:.3f} ms on "
        f"two gloo ranks | card: {card}")
    log(line)
    return {"launches": a["launches"] + b["launches"], "a": a, "b": b,
            "lines": [a["line"], b["line"], line]}


def save_witness(path: str, data: dict) -> None:
    import pickle
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)


def csr_witness_data(packed, ll, nf, opts, res, overflow) -> dict:
    """A CsrBeamDecoder batch for tests/test_torch_csr_witness.py: the
    packed graph's arrays, each utterance's loglikes [T_b, P] (unpadded),
    the search options and the decoder's words, costs and overflow."""
    import dataclasses
    import torch
    ll = ll.cpu().numpy() if isinstance(ll, torch.Tensor) else np.asarray(ll)
    nf = np.asarray(nf)
    return dict(graph=dataclasses.asdict(packed),
                loglikes=[ll[b, :nf[b]].copy() for b in range(len(nf))],
                opts=dataclasses.asdict(opts),
                words=[None if r is None else [int(x) for x in r[0]]
                       for r in res],
                costs=[None if r is None else float(r[2]) for r in res],
                overflow=np.asarray(overflow).tolist())


def lvtln_witness_data(lv, stats: dict) -> dict:
    """Phase 28 (b)'s LVTLN selection: the class transforms and, per
    speaker, its fMLLR statistics and the card's class and auxiliary per
    class."""
    out = {"warps": list(lv.warps), "A": lv.A.cpu().numpy(),
           "default_class": lv.default_class, "speakers": {}}
    for s, st in stats.items():
        c, W, aux = lv.select_class(st)
        out["speakers"][s] = dict(beta=float(st.beta), K=st.K.copy(),
                                  G=st.G.copy(), cls=int(c),
                                  W=np.asarray(W), aux=np.asarray(aux))
    return out


def _pdf_params(am) -> list:
    return [(p.weights.copy(), p.means.copy(), p.vars.copy())
            for p in am.pdfs]


class SatWitness:
    """Records train_sat's first fMLLR iteration in the port: the inputs
    and result of `estimate_speaker_transforms` (the model, the current
    features, alignments and speakers), then that iteration's `_update`
    (the model before, the accumulators, the model after). Use as a
    context manager around `train_sat`."""

    def __enter__(self):
        from kaldi_tpu_torch.steps import sat
        self.sat, self.data = sat, {}
        self._est, self._upd = sat.estimate_speaker_transforms, sat._update
        sat.estimate_speaker_transforms = self.estimate
        sat._update = self.update
        return self

    def __exit__(self, *exc):
        self.sat.estimate_speaker_transforms = self._est
        self.sat._update = self._upd

    def estimate(self, model, utts, align, min_count=100.0, init=None):
        delta = self._est(model, utts, align, min_count, init)
        if "estimate" not in self.data:
            self.data["estimate"] = dict(
                pdfs=_pdf_params(model.am),
                id2pdf=np.asarray(model.trans_model.id2pdf_array),
                utts=[(u, np.asarray(f, np.float32), s)
                      for u, f, _w, s in utts],
                align=[None if r is None else np.asarray(r[0])
                       for r in align],
                min_count=float(min_count),
                delta={s: np.asarray(W) for s, W in delta.items()})
        return delta

    def update(self, model, acc, tcounts, opts, target):
        first = "estimate" in self.data and "update" not in self.data
        before = _pdf_params(model.am) if first else None
        accs = [(a.occ.copy(), a.mean_acc.copy(), a.var_acc.copy())
                for a in acc.accs] if first else None
        self._upd(model, acc, tcounts, opts, target)
        if first:
            self.data["update"] = dict(
                before=before, accs=accs, target=target,
                min_gaussian_occupancy=opts.min_gaussian_occupancy,
                perturb_factor=opts.perturb_factor, power=opts.power,
                after=_pdf_params(model.am))


def smbr_witness_data(am, tm, eg, opts, silence_phones) -> dict:
    """Phase 22 (b)'s first sMBR minibatch before training: the eg
    (features with context, numerator alignment, the lattice), the TDNN's
    config, params and priors, and the card's loglikes, dense signed
    posteriors, objective and gradient of the surrogate loss
    -sum(post * logprob) at those params."""
    import copy
    import torch
    from torch.func import functional_call
    from kaldi_tpu_torch.nnet import discriminative as nd
    feats, ali, lat = eg
    model = am.model
    lc = model.config.left_context
    lat0 = copy.deepcopy(lat)
    ll = am.loglikes_np(feats[None])[0][lc:lc + len(ali)]
    post, objf = nd.compute_discriminative_post(
        am, copy.deepcopy(lat), ali, tm, opts, ll, silence_phones)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.params().items()}
    x = torch.as_tensor(np.asarray(feats, np.float32),
                        device=am.device)[None]
    logprob = functional_call(model, params, (x,),
                              dict(pad_context=False))[0]
    loss = -(torch.as_tensor(post, device=am.device) * logprob).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(feats=np.asarray(feats, np.float32), ali=np.asarray(ali),
                lattice=lat0, config=dataclasses.asdict(model.config),
                params={k: v.detach().cpu().numpy()
                        for k, v in params.items()},
                priors=np.asarray(am.priors), tm=tm,
                silence_phones=sorted(silence_phones),
                opts=dataclasses.asdict(opts), ll=ll, post=post,
                objf=float(objf), loss=float(loss.detach()),
                grads={k: g.cpu().numpy() for k, g in zip(params, grads)})



def device_time(fn) -> tuple[float, int, dict]:
    """Run fn under torch.profiler. -> (device busy seconds: the sum of
    kernel, memcpy and memset durations, which do not overlap on one
    stream; device op count; {name: [us, count]})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in dev:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    return sum(e.time_range.elapsed_us() for e in dev) / 1e6, len(dev), by_name


def log_profile(what: str, per: str, n: int, busy: float, n_ops: int,
                by_name: dict, host_s_per: float, top: int):
    """Device busy time per unit against the unprofiled host time per unit,
    and the device ops that take the time."""
    log(f"  profile ({what}): device busy {busy / n * 1e3:.4f} ms/{per} in "
        f"{n_ops / n:.1f} device ops/{per}; unprofiled host "
        f"{host_s_per * 1e3:.4f} ms/{per} -> device idle "
        f"{100 * (1 - busy / n / host_s_per):.1f}%")
    for name, (us, k) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(f"    {us / n:9.2f} us/{per} {k / n:6.1f}/{per}  {name[:80]}")


# device kernels by kind, by a substring of the kernel's name
KERNEL_KINDS = (("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
                ("copy and cast", ("copy", "Memcpy", "Memset")),
                ("reduction", ("reduce",)))


def log_by_kind(by_name: dict, n: int, per: str):
    """Device time per unit summed by KERNEL_KINDS; the rest is
    elementwise and other kernels."""
    kinds: dict[str, list] = {}
    for name, (us, k) in by_name.items():
        kind = next((kind for kind, keys in KERNEL_KINDS
                     if any(key in name for key in keys)),
                    "elementwise and other")
        acc = kinds.setdefault(kind, [0.0, 0])
        acc[0] += us
        acc[1] += k
    log("  by kind: " + "; ".join(
        f"{kind} {us / n / 1e3:.4f} ms/{per} in {k / n:.1f} ops"
        for kind, (us, k) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))


def profile_decode(dec, ll, frames: int, host_s_per_frame: float):
    """One decode of the first `frames` frames under torch.profiler."""
    ll = ll[:, :frames].contiguous()
    B = ll.shape[0]
    busy, n_ops, by_name = device_time(
        lambda: dec.decode(ll, np.full(B, frames, np.int32)))
    log_profile(f"{frames} frames x {B} utts", "frame", frames, busy, n_ops,
                by_name, host_s_per_frame, 25)


def profile_stream(srv, waves, chunk: int, host_s_per_step: float):
    """Six steady streaming steps (all slots fed, past the first chunks)
    under torch.profiler."""
    slots = [srv.open() for _ in waves]
    for s, w in zip(slots, waves):
        srv.feed(s, w[:10 * chunk])
    for _ in range(4):
        srv.step()
    n = 6
    busy, n_ops, by_name = device_time(
        lambda: [srv.step() for _ in range(n)])
    for s in slots:
        srv.close(s)
    log_profile(f"{n} steady steps x {len(slots)} streams", "step", n, busy,
                n_ops, by_name, host_s_per_step, 12)


def build_native() -> list[str]:
    """Build the g++ libraries (graph ops, lattice extraction, ark reader)
    that the phases would otherwise build one by one at first use, all at
    once. -> their paths."""
    from concurrent.futures import ThreadPoolExecutor
    from kaldi_tpu_torch.fst import native_ops
    from kaldi_tpu_torch.io import native as ark_native
    from kaldi_tpu_torch.lat import native_gen
    mods = (native_ops, native_gen, ark_native)
    loads = (native_ops._load, native_gen._load, ark_native.load)
    with ThreadPoolExecutor(len(loads)) as ex:
        for f in [ex.submit(load) for load in loads]:
            f.result()
    return [m.library_path() for m in mods]


def side_phases() -> int:
    """The second process (`SIDE_FLAG`): the bench graph's chain (phases
    7, 8, 10, 13, 14, 34, 36, 18, 30 a and c), the CLI's GMM recipe at the
    ladder's width (37), its decode and scoring back half (38) and the
    neural recipes on its files (39), the adaptation and SGMM2 chain on
    phase 37's files (41), the triphone ladder small (19), then the
    SMALL_PHASES; the launch counts and its end go to SIDE_RESULTS."""
    import torch
    from kaldi_tpu_torch.device import card_info, resolve_device
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg
    resolve_device("cuda")                # also turns TF32 off
    torch.set_num_threads(SIDE_THREADS)
    card = card_info()
    profile = "--profile" in sys.argv[1:]
    log_phase("[7/42] full-width serving slice (bf16 TDNN)")
    sl = phase_slice(tg, card, profile=profile)
    log_phase("[8/42] full-width int8 serving slice")
    s8 = phase_int8_slice(q, tg, sl, card)
    log_phase("[10/42] streaming server, full width")
    st = phase_stream_full(tg, sl, card, profile=profile)
    log_phase("[13/42] training, full width: the bench's AM with the port's "
              "train step")
    tr = phase_train_full(sl, card, profile=profile)
    log_phase("[14/42] lattice path, full width (latgen at the bench's "
              "point)")
    lt = phase_lattice_full(tg, sl, tr, card)
    log_phase("[34/42] decoder tools at the bench graph's width: the "
              "verifiers over its tier tables, decode_batched with phase 13's "
              "AM, the self-built triphone graph")
    tl = phase_tools_full(tg, sl, tr, card)
    log_phase("[36/42] the bench decode through files: compute-fbank-feats "
              "-> compute-cmvn-stats / apply-cmvn -> nnet-am-compute with "
              "phase 13's AM -> decode-faster-mapped on the bench graph -> "
              "compute-wer")
    cb = phase_cli_bench(tg, sl, tr, tl, card)
    log_phase("[18/42] GMM path, full width: monophone training, the dense "
              "decoder's serving lines")
    phase_gmm_full(tr, card, profile=profile)
    log_phase("[30/42] (a, c) rescoring at width: bench.py's 1.13M-n-gram "
              "trigram over phase 14's lattices with the truncation audit; "
              "features on the bench's test waves")
    phase_rescore_bench(card, lt)
    log_phase("[37/42] Kaldi's train_mono.sh -> train_deltas.sh -> "
              "mkgraph.sh -> decode through the CLI's files at the triphone "
              "ladder's width")
    lc = phase_ladder_cli(card)
    log_phase("[38/42] Kaldi's decode.sh -> score.sh -> "
              "lmrescore_const_arpa.sh -> confidences, posteriors, KWS -> "
              "decode_fmllr.sh through the CLI's files on phase 37's")
    lt38 = phase_lattice_cli(card, lc)
    log_phase("[39/42] Kaldi's nnet2, nnet3 and DBN recipes "
              "(train_multisplice_accel2.sh, train_tdnn.sh, pretrain_dbn.sh "
              "-> train.sh -> decode.sh) through the CLI's files on phase "
              "37's")
    nc = phase_nnet_cli(card, lc)
    log_phase("[41/42] Kaldi's train_sat.sh -> decode_fmllr.sh -> "
              "train_ubm.sh -> train_sgmm2.sh -> decode_sgmm2.sh through "
              "the CLI's files on phase 37's")
    ac = phase_adapt_cli(card, lc)
    log_phase("[19/42] triphone ladder, small: card vs CPU")
    phase_ladder_small()
    for k, what, fn in SMALL_PHASES:
        if k == 31:
            socket.setdefaulttimeout(SOCKET_TIMEOUT_S)
        log_phase(f"[{k}/42] {what}")
        globals()[fn]()
    with open(SIDE_RESULTS, "w") as f:
        json.dump({"slice": sl["launches"], "int8": s8["launches"],
                   "stream": st["launches"], "latgen": lt["launches"],
                   "adaptive": lt["adaptive_launches"],
                   "tools": tl["launches"],
                   "tools_graph": tl["graph_launches"],
                   "cli": cb["launches"],
                   "cli_shapes": cb["gather_times"],
                   "ladder_cli": lc["launches"],
                   "lattice_cli": lt38["launches"],
                   "nnet_cli": nc["launches"],
                   "adapt_cli": ac["launches"], "ended": time.time()}, f)
    log(f"the second process's phases in "
        f"{time.perf_counter() - T_START:.1f} s")
    return 0


def start_side_phases():
    """-> the second process, its stdout in SIDE_LOG and its stderr this
    one's."""
    import subprocess
    os.makedirs(os.path.dirname(SIDE_LOG), exist_ok=True)
    if os.path.exists(SIDE_RESULTS):
        os.remove(SIDE_RESULTS)
    with open(SIDE_LOG, "w") as out:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), SIDE_FLAG]
            + [a for a in sys.argv[1:] if a == "--profile"],
            stdout=out, cwd=ROOT)


def finish_side_phases(proc) -> dict:
    """Wait for the second process, copy its log here, fail with it. ->
    its launch counts."""
    import subprocess
    try:
        rc = proc.wait(timeout=max(STACKS_AFTER_S + 150
                                   - (time.perf_counter() - T_START), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at the time limit"
    with open(SIDE_LOG) as f:
        for line in f:
            log(line.rstrip("\n"))
    if rc != 0:
        raise AssertionError(f"the second process failed ({rc})")
    with open(SIDE_RESULTS) as f:
        return json.load(f)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a card", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(STACKS_AFTER_S)
    sys.path.insert(0, ROOT)
    if SIDE_FLAG in sys.argv[1:]:
        return side_phases()
    if PARALLEL_FLAG in sys.argv[1:]:
        return parallel_rank()
    from kaldi_tpu_torch import cuda_build
    from kaldi_tpu_torch.device import card_info, resolve_device
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    resolve_device("cuda")                # also turns TF32 off
    card = card_info()
    log_phase(f"[1/42] card: {card} | torch {torch.__version__} CUDA "
              f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}")

    t = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as ex:
        native = ex.submit(build_native)
        libs = cuda_build.build()
        native = native.result()
    log_phase(f"[2/42] build: {len(libs)} kernels (one nvcc each) and "
              f"{len(native)} g++ libraries, all at once, in "
              f"{time.perf_counter() - t:.3f} s")
    for name, so in libs.items():
        with open(os.path.join(os.path.dirname(so), "nvcc.log")) as f:
            regs = [ln.split("info    : ")[-1] for ln in f
                    if "registers" in ln or "spill" in ln]
        log(f"  {os.path.relpath(so, ROOT)}: {' | '.join(regs)}")

    log_phase("[3/42] table-gather kernel vs plain version")
    k = phase_kernel(tg)
    log_phase("[4/42] qaffine kernel vs plain version")
    qk = phase_qaffine(q)
    side = start_side_phases()            # beside the phases below
    try:
        log_phase("[16/42] online path, full width "
                  "(scripts/bench_streaming.py's configuration)")
        on = phase_online_full(tg, card, profile="--profile" in sys.argv[1:])
        log_phase("[20/42] triphone ladder, full width: mono -> tri -> "
                  "LDA+MLLT -> TDNN, and SAT")
        ld = phase_ladder_full(card, profile="--profile" in sys.argv[1:])
        log_phase("[22/42] discriminative path, full width: the rm-like "
                  "pyramid with bMMI and fMMI, then bMMI and TDNN sMBR on the "
                  "ladder's models")
        dk = phase_disc_full(card, ld, profile="--profile" in sys.argv[1:])
        log_phase("[24/42] nnet3 and nnet1 families at the ladder's width: "
                  "nnet3 TDNN and LSTM, the wide LSTM, the DBN")
        nn = phase_nnet_full(card, ld, profile="--profile" in sys.argv[1:])
        log_phase("[26/42] speaker recognition at sre10's width (2048 "
                  "gaussians, 600-dim i-vectors, 60-dim features): v1 and v2, "
                  "then logistic regression")
        sr = phase_sre_full(card, ld)
        log_phase("[28/42] adaptation and SGMM2 at the ladder's width: raw, "
                  "basis, regression-tree and global fMLLR, MLLR, LVTLN, "
                  "HLDA; SGMM2 at egs/rm's sgmm2_4a widths, bMMI, SGMM fMLLR")
        ad = phase_adapt_sgmm_full(card, ld)
        log_phase("[30/42] (b) search at width: the ladder's lattices "
                  "through rescoring, scoring, MBR, ctm, KWS and "
                  "decode_biglm")
        rs = phase_rescore_ladder(card, ld)
        socket.setdefaulttimeout(SOCKET_TIMEOUT_S)
        log_phase("[32/42] network serving at phase 16's configuration: its "
                  "AM and HCLG through the port's files, the TCP server over "
                  "6 concurrent connections (also through µ-law and ADPCM), "
                  "the threaded decoder, the online GMM decoder over phase "
                  "20's tri, the CLI")
        sv = phase_serving_full(tg, card, on, ld)
        log_phase("[40/42] egs/sre10 v1's run.sh through the CLI's files on "
                  "phase 26's corpus: compute-mfcc-feats -> add-deltas -> "
                  "compute-vad -> select-voiced-frames -> train-ubm --full -> "
                  "train-ivector-extractor -> ivector-extract -> mean, "
                  "centring, length -> ivector-compute-plda -> "
                  "ivector-plda-scoring / ivector-compute-dot-products -> "
                  "compute-eer; logistic regression")
        sc = phase_sre_cli(card)
        log_phase("[35/42] the CLI's five slices, small: every "
                  "device subcommand and the first slice's host ones on the "
                  "card and with --device cpu, recipe-yesno-files on the "
                  "card, --fused vs the generic pipeline, train-nnet3's "
                  "round trip, the card probes")
        phase_cli_small()
        log_phase("[42/42] the multi-device slice: (a) one rank over NCCL, "
                  "mesh (1, 1); (b) two ranks on the one card over gloo: the "
                  "frontier-sharded decode at the bench's width, the "
                  "utterance-sharded decode, data-parallel training")
        pl = phase_parallel(tg, q, card)
        main_end = time.perf_counter() - T_START
        sd = finish_side_phases(side)
        side_end = sd["ended"] - T_START_WALL
        log("phase 42's lines again (the second process's log came between):")
        for line in pl["lines"]:
            log(line)
        log(f"this process's phases ended at {main_end:.1f} s, the second "
            f"process's at {side_end:.1f} s (both on this one's clock): "
            f"{abs(main_end - side_end):.1f} s apart")
    finally:
        if side.poll() is None:
            side.kill()
            side.wait()

    g_shape = GATHER_SHAPES[0]
    ms, plain_ms, library_ms, floor_ms = k["times"][g_shape]
    log(f"launches: gather {sd['slice']} on the bf16 slice, "
        f"{sd['stream']} on the streaming path, {sd['latgen']} on the "
        f"latgen path, {sd['adaptive']} in the adaptive decode, "
        f"{on['launches']} on the fused online path, {ld['launches']} on "
        f"the triphone ladder's decodes, {dk['launches']} on the "
        f"discriminative path's, {nn['launches']} on the nnet families', "
        f"{sr['gather_launches']} on the speaker-recognition path's, "
        f"{ad['launches']} on the adaptation and SGMM path's, "
        f"{rs['launches']} on the rescoring and search path's (phase 30's "
        f"ladder decodes), {sv['launches']} on the TCP server's (phase 32's "
        f"6 connections), {sd['tools']} in phase 34's decode_batched and "
        f"{sd['tools_graph']} on its self-built graph, {sd['cli']} in phase "
        f"36's decode-faster-mapped, {sd['ladder_cli']['gather']} in phase "
        f"37's CLI recipe, {sd['lattice_cli']['gather']} in phase 38's, "
        f"{sd['nnet_cli']['gather']} in phase 39's, "
        f"{sc['launches']['gather']} in phase 40's, "
        f"{sd['adapt_cli']['gather']} in phase 41's, {pl['launches']} on "
        f"the multi-device path (phase 42: {pl['a']['launches']} over NCCL, "
        f"{pl['b']['launches']} in the two gloo ranks); "
        f"qaffine {sd['int8']} "
        f"on the int8 slice, "
        f"{sr['qaffine_launches']} on the speaker-recognition path's, 0 on "
        f"the adaptation and SGMM path's, on the rescoring path's and on "
        f"the server's, the decoder tools' and the CLI's (phases 27-30 and "
        f"32-36 assert it), {sd['ladder_cli']['qaffine']} in phase 37's, "
        f"{sd['lattice_cli']['qaffine']} in phase 38's, "
        f"{sd['nnet_cli']['qaffine']} in phase 39's, "
        f"{sc['launches']['qaffine']} in phase 40's, "
        f"{sd['adapt_cli']['qaffine']} in phase 41's, 0 in phase 42's (it "
        f"asserts it)")
    faulthandler.cancel_dump_traceback_later()
    log(f"all 42 phases in {time.perf_counter() - T_START:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "batched_table_gather", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/table_gather.cu",
        "replaces": "kaldi_tpu/ops/table_gather.py:50",
        "launches": sd["slice"], "lattice_launches": sd["latgen"],
        "online_launches": on["launches"],
        "ladder_launches": ld["launches"],
        "max_abs_err": k["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": gather_bound_ms(*g_shape), "bound_by": "bytes",
        "library_ms": library_ms, "floor_ms": floor_ms,
        "online_shape": on["shape"], "online_ms": on["times"][0],
        "online_plain_ms": on["times"][1],
        "online_library_ms": on["times"][2],
        "online_bound_ms": gather_bound_ms(*on["shape"]),
        "ladder_shapes": [{
            "shape": list(sh), "ms": t[0], "plain_ms": t[1],
            "library_ms": t[2], "bound_ms": gather_bound_ms(*sh)}
            for sh, t in ld["gather_times"].items()],
        "disc_launches": dk["launches"],
        "disc_shapes": [{
            "shape": list(sh), "ms": t[0], "plain_ms": t[1],
            "library_ms": t[2], "bound_ms": gather_bound_ms(*sh)}
            for sh, t in dk["gather_times"].items()],
        "nnet_launches": nn["launches"],
        "nnet_shapes": [{
            "shape": list(sh), "ms": t[0], "plain_ms": t[1],
            "library_ms": t[2], "bound_ms": gather_bound_ms(*sh)}
            for sh, t in nn["gather_times"].items()],
        "sre_launches": sr["gather_launches"],
        "adapt_sgmm_launches": ad["launches"],
        "rescore_launches": rs["launches"],
        "server_launches": sv["launches"], "server_shape": sv["shape"],
        "server_ms": sv["times"][0], "server_plain_ms": sv["times"][1],
        "server_library_ms": sv["times"][2],
        "server_bound_ms": gather_bound_ms(*sv["shape"]),
        "tools_launches": sd["tools"],
        "tools_graph_launches": sd["tools_graph"],
        "cli_launches": sd["cli"], "cli_shapes": sd["cli_shapes"],
        "ladder_cli_launches": sd["ladder_cli"]["gather"],
        "lattice_cli_launches": sd["lattice_cli"]["gather"],
        "nnet_cli_launches": sd["nnet_cli"]["gather"],
        "sre_cli_launches": sc["launches"]["gather"],
        "adapt_cli_launches": sd["adapt_cli"]["gather"],
        "parallel_launches": pl["launches"]}, {
        "name": "qaffine", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/qaffine.cu",
        "replaces": "kaldi_tpu/nnet/quantized.py:46",
        "launches": sd["int8"], "max_abs_err": qk["max_abs_err"],
        "max_rel_err": qk["max_rel_err"],
        "ms": qk["ms"], "plain_ms": qk["plain_ms"],
        "max_rel_err_f64": qk["max_rel_err_f64"],
        "plain_max_rel_err_f64": qk["plain_max_rel_err_f64"],
        "bound_ms": qk["bound_ms"], "bound_by": qk["bound_by"],
        "three_pass_bound_ms": qk["three_pass_bound_ms"],
        "fp32_bound_ms": qk["fp32_bound_ms"],
        "library_ms": qk["library_ms"],
        "sre_launches": sr["qaffine_launches"],
        "adapt_sgmm_launches": 0, "rescore_launches": 0,
        "server_launches": 0, "tools_launches": 0, "cli_launches": 0,
        "ladder_cli_launches": sd["ladder_cli"]["qaffine"],
        "lattice_cli_launches": sd["lattice_cli"]["qaffine"],
        "nnet_cli_launches": sd["nnet_cli"]["qaffine"],
        "sre_cli_launches": sc["launches"]["qaffine"],
        "adapt_cli_launches": sd["adapt_cli"]["qaffine"],
        "parallel_launches": 0}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
