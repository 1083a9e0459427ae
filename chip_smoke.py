#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout. It builds the port's CUDA kernels from
csrc/ (nvcc) and the native decoder from native/ (g++), and drives the
port only (no JAX). Every phase asserts; any failure exits non-zero.
It holds what neither the port's card tests (pytest tests that take the
`card` fixture of tests/torch_card.py, beside each module's CPU tests)
nor the benchmark's cells (benchmark/) hold: the paths no cell runs,
driven end to end, and the kernels alone. A new kernel or path adds card
tests, not a phase here. Phases:

  1. the card's name and power limit (nvidia-smi) and the kernel builds,
     with each compiled entry function's registers and spills
     (kernels.register_report; none allowed in the K1 instantiations that
     the configs' launch plans pick);
  2. K1 (csrc/lpc_cepstra.cu) against its plain PyTorch version on AR
     lags (rtol = atol = 1e-4) at the three config shapes, ragged and odd
     row counts, unity gain, lim = 1, lim = 2, lim > order + 1, and orders
     at and just past the configs' plans' chunk boundaries; every lane
     count and block size at the three swept shapes (checked); on the real
     FDLP lags of a near-periodic input (finite; rtol = atol = 5e-3 and
     each coefficient's error within 0.15 of its mean magnitude at lim
     100, 0.2 at lim 450); then each kernel alone at its cell's shape
     (kernel_table: K1, K2, K3, each against its plain version in its own
     measure, K1 1e-4 as above, K2 1e-5 element by element, K3 2e-5 over
     each tensor's largest entry; device ms by CUDA-graph replay, the
     bound and its share, the port's call, plain and library ms), the
     kernels line's numbers;
  3. featgen at the wsj_fdlp_e2e front-end (80 bands, order 150, 1.5 s)
     on 32 utterances of 6-10 s: backend 'auto' (K1) against 'scan'
     (plain), rtol 1e-3 / atol 2e-3 on valid frames;
  4. the main path, the hybrid slice at timit_hybrid: FDLP (20 bands,
     order 50, 0.5 s) -> global CMVN -> 3 x 512 GRU RNNClassifier ->
     3,376-class prior-normalised log-likelihoods, on 32 utterances of
     2-6 s with seeded random weights; K1's launches are counted over this
     run; the log-likelihoods are held against the same chain with the
     plain LPC backend (atol 1e-2) and the AM against itself on the CPU;
     K1 against its plain version on the main path's own lags (rtol =
     atol = 1e-3 and each coefficient's error within 1e-2 of its mean
     magnitude); per-batch times and torch.profiler breakdowns of device
     time of the front-end and the AM;
  5. the e2e slice at wsj_fdlp_e2e on phase 3's batch: FDLP (K1) ->
     global CMVN -> TransformerASR (vocab 52, adim 256, 4 heads, 12/6
     layers, FFN 2048) -> beam 10 joint CTC/attention search (ctc_weight
     0.3, max_len 100) with a 1 x 1000 GRU RNNLM at weight 1.0, seeded
     random weights; K1's launches are counted over one recognize_batch
     call, whose texts must equal those of the chain run part by part;
     CTC log-probs from K1 features held against the plain backend's
     (E2E_CTC_TOL), the encoder against the CPU (atol 1e-4, two
     utterances), the search against the CPU from the same memory (best
     scores within 1e-4 relative, max_len E2E_CPU_MAX_LEN; token-identical
     hypotheses counted); K2's launches counted over the recognize_batch
     call and, one a step, over the search run part by part;
  6. hybrid training at timit_hybrid on phase 4's 32 utterances: FDLP (K1)
     -> global CMVN -> build_egs with seeded frame labels over 3,376
     classes -> train_am.main --arch rnn (3 x 512 GRU, Adam lr 1e-3, clip
     1.0, lrr 0.5) for 2 epochs of 2 batches plus a dev batch; finite
     losses, a checkpoint that loads back, K1's launches counted over the
     path, K3's over train_am.main (2 x layers a train step and layers a
     dev batch, the main path's count); one step card against CPU on the
     same weights and batch (loss 1e-5 relative, gradient norm 1e-4
     relative, update 1e-3 x lr);
  7. e2e training at wsj_fdlp_e2e on phase 3's 32 utterances: FDLP (K1) ->
     global CMVN -> build_egs (each utterance twice, with two seeded
     transcripts over the 52-symbol vocabulary that CTC can align, some
     with repeated characters) -> train_e2e.main at full width (dropout
     0.1, Noam warmup 25000 factor 10, Adam b2 0.98, clip 5) for 2 epochs
     of 2 batches of 32 with --average_last 2; its final_avg checkpoint
     decodes two utterances through recognize_batch; one step at dropout
     0 card against CPU (loss and its CTC and attention parts 1e-5
     relative, gradient norm 1e-4 relative); the port's CTC loss against
     torch's F.ctc_loss on the card (per-token losses atol 1e-4, both
     timed); ms a step split into encoder, decoder, CTC loss, the rest of
     the loss, backward and optimizer, peak memory, a profile and audio
     seconds trained per wall second;
  8. online serving at wsj_fdlp_e2e width with attn_chunk 16 / left 4 (the
     recipes' streaming setting): a model directory written by
     save_checkpoint (seeded weights, vocab.json, serving.json with phase
     3's front-end, global CMVN of phase 3's features) and a 1 x 1000 RNNLM;
     cli.serve.make_server(max_streams 8, defer 30 ms) on a local socket;
     8 concurrent clients each stream one of phase 3's utterances in 0.25 s
     pcm messages, unpaced, then eof, and one more runs with endpointing
     ({"config": {"endpoint_blanks": N}}); K1's launches are counted over
     these streams. Each final is held to OnlineASRPipeline on the same
     audio (a mismatch only at a CTC near-tie, top two within 1e-4);
     StreamingFdlp's features against fdlp_spectrogram_batch
     (SERVE_FEAT_TOL); the streamed encoder memory against the offline
     chunked encode (atol 1e-4); K1 against its plain version on the
     streamer's own lags (one window: 80 rows; a block of 8: 640 rows);
     cli.transcribe on two wavs against the pipeline; cli.recog_e2e
     --jit_decode against --streaming (beam, the RNNLM, max_len 25) on 4
     utterances. Prints encoder ms a round (device and wall), featgen ms a
     push, partial and final latencies, audio s per wall s, K1 at the
     serving shapes and a profile of ten rounds;
  9. in phase 6's directory: the e2e recipe's LM stage, train_lm.main at
     wsj_fdlp_e2e's LM width (1 x 1000 GRU, embed 256, phase 5's 52-token
     vocabulary, batch 64, bptt_len 128) for one epoch of 8 batches of
     seeded transcripts; one step card against CPU (loss 1e-5 relative,
     the Adam update 1e-3 x lr), a step's ms and tokens/s, and the final
     checkpoint loaded by recog_e2e._load_lm and fused into one search of
     phase 5's model. Then the hybrid decode end at timit_hybrid: featgen
     (K1, counted) and egs of 12 decode utterances, compute_prior on phase
     6's egs, train_ngram (order 3) on the decode transcripts over a
     synthetic lexicon of pdf ids below 3,376, decode_wfst build-graph
     (states_per_phone 1), dump_outputs --prior --prior_weight 0.8 of phase
     6's checkpoint on the card and on the CPU (max|LL card - CPU| <= 1e-4),
     decode_wfst decode (acoustic_scale 0.1, beam 16, max_active 7000) over
     both arks, hypotheses held card against CPU; wall s by stage, decode
     ms per utterance and the real-time factor of dump + decode. Last,
     phase 5's model at ctc_weight 1.0: finite scores, no blank in a best
     hypothesis;
  10. (a) the MFCC hybrid front-end at wsj_hybrid (recipes/configs/
     wsj_hybrid.json: 16 kHz, 30 filters, 0.02 s, nfft 1024, 13 cepstra)
     on phase 3's 32 utterances written as wavs: compute_mfcc.main and
     compute_mel_spectrum.main (23 filters, log) on the card and on the
     CPU, features held card against CPU (MFCC_TOL) on every frame, the
     real-time factor of each CLI and of mfcc_batch alone; one
     compute_mfcc run with --profile_dir, whose trace file must appear;
     egs with per-utterance CMVN as run_corpus.py computes it and context
     4 recorded; train_am.main --arch rnn at wsj_hybrid's width (4 x 300
     GRU, 13 features, 3,376 classes, batch 64) for one epoch of 2
     batches; one step card against CPU on 4 utterances of 150 frames
     (loss 1e-5 relative). (b) the conformer at wsj_fdlp_conformer_e2e (adim 256, 4
     heads, 12 conformer layers with conv_kernel 15, FFN 2048, 6 decoder
     layers) on phase 3's batch with global CMVN and seeded weights with
     nonzero biases: recognize_batch (FDLP on K1, counted; beam 10,
     ctc_weight 0.3, the 1 x 1000 RNNLM, max_len CONF_MAX_LEN) against
     the chain run part by part; CTC log-probs from K1 features against
     the plain backend's (E2E_CTC_TOL); the encoder card against CPU on
     two utterances (atol 1e-4); train_e2e.main --encoder_type conformer
     on phase 7's egs for one epoch of 2 batches of 32, its final_avg
     decoded by recog_e2e.main on 4 utterances; then with attn_chunk 16
     / left 4, from a model directory (serving.json, CMVN), the streamed
     encoder memory against the offline chunked encode (atol 1e-4) and 5
     streams through a 4-row StreamBatcher (one slot reused) whose finals
     equal per-stream OnlineASRPipeline runs (K1 counted; a mismatch only
     at a CTC near-tie). Each part prints its wall and device ms and busy
     share;
  11. (a) wsj_fdlp_e2e's front-end at precision 'high' (float64 from the
     window multiply on) on phase 3's batch: no K1 launch, the card against
     the CPU on 4 utterances and 'blocked:15' against 'scan' at float64 I/O
     (HIGH_TOL), high against phase 3's fast features (HIGH_VS_FAST_MAX,
     HIGH_VS_FAST_P999), ms a batch and
     the float64 LPC stage's ms by backend, a profile. (b)
     compute_modulation_spectrum.main at its CLI defaults (15 bands, order
     50, coefficients 5-30, batch 8) on phase 3's 32 utterances as wavs:
     the default, --set_unity_gain, --complex_modulation and
     --complex_modulation --absolute_value, card against CPU on 4
     utterances (real: MODSPEC_TOL of the features' scale; complex: finite,
     MODSPEC_COMPLEX_TOL on all but MODSPEC_COMPLEX_SHARE of the entries,
     and card against CPU in float64 within MODSPEC_F64_TOL);
     K1 launched on the real runs (counted) and the plain version never
     reached there, the complex runs on the plain loops; K1 against its
     plain version on the path's own lags with unity gain off and on
     (MODSPEC_K1_TOL, MODSPEC_K1_REL), its kernel ms, plain ms and bound; the
     batch's and the CLI's real-time factors and a profile. (c) phase 5's
     search on its 32 encoded utterances, the fixed-buffer KV-cached step
     replayed as a CUDA graph against the eager full-prefix loop:
     hypotheses token-identical (a difference only at a near-tie), best
     scores within INCR_SCORE_REL, max_len INCR_MAX_LEN; ms a step both
     ways;
  12. (a) bf16 mixed precision on phase 5's weights and phase 3's batch:
     recognize_batch with compute_dtype bfloat16 (FDLP on K1, counted;
     BF16_MAX_LEN) against the float32 chain in the same call (encoder ms,
     ms a search step, CTC logits within BF16_VS_F32_REL of their scale,
     token-identical share); bf16 on the card against bf16 on the CPU for
     BF16_CPU_UTTS utterances
     (BF16_DEVICE_REL; the KV-cached search with its bf16 cache);
     train_e2e.main --compute_dtype bfloat16 on phase 7's egs (1 epoch of 2
     batches of 32; float32 params and Adam state in the checkpoint), a
     step timed against a float32 step on the same batch; the conformer of
     phase 10 (b) encoding in bf16; 5 streams through a bf16 StreamBatcher
     at attn_chunk 16 / left 4 against the offline bf16 chunked encode
     (BF16_STREAM_REL). (b) train_lm.main --cell lstm at wsj_fdlp_e2e's LM
     width on phase 9's transcripts (8 batches of 64, bptt 128): first-step
     loss card against CPU (1e-5), ms a step and tokens/s; phase 5's search
     fused with it, card against CPU, token-identical on 4 utterances. (c)
     seeded checkpoints in the source toolkits' layouts (an ESPnet e2e
     transformer at wsj_fdlp_e2e's widths with its units file, a
     DefaultRNNLM 1 x 1000 LSTM, a reference nnetRNN .model dict at
     timit_hybrid's widths) imported by import_torch_ckpt.main; recog_e2e
     on the imported model with the imported LM over phase 7's egs, and
     dump_outputs on the imported hybrid model over phase 6's egs; each
     imported model held to its torch reconstruction on the card
     (IMPORT_*_ATOL);
  13. (a) the hybrid recipes' stage 6 at timit_hybrid (PM_TRAIN): FDLP
     (K1, counted, then held to its plain version on the path's lags) of
     32 held-out utterances with phase 6's CMVN -> dump_outputs --prior of
     phase 6's AM -> build_egs of the 3,376-dim log-likelihoods ->
     train_am.main --arch pm_ae --loss mse (2 + 2 x 512, bn 64; one epoch
     of 2 batches of 32) -> pm_score_cli pm (reconstruction and
     --contrastive) and mmeasure: ms a PM step, scores per second, scores
     card against CPU (ZOO_OUT_REL). (b) every other arch of the recurrent
     half at train_am's defaults (ZOO_TRAIN) but ZOO_B_LAYERS layers over
     phase 6's egs, with
     vae --use_transformer (over phase 7's 80-band egs), multimod
     --multi_egs_dirs, feedforward
     --frame_egs, vae_encoded / curl_encoded on the vae / curl just trained
     and curl --expand_from: ms a step; on the initial weights, the
     first-step loss card against CPU with the same noise (ZOO_LOSS_REL)
     and dump_outputs card against CPU (ZOO_OUT_REL); tandem_feats
     --get_pca on phase 6's AM;
  14. (a) the conv half of the zoo at train_am's defaults (ZOO_TRAIN)
     over phase 13's doubled egs: cnn, cldnn, vae_cnn, vae_cnn_pool,
     rs_vae, modnet, modnet_sigmoid, each one epoch of 2 batches of 32: ms
     a step; on the initial weights, the first-step loss card against CPU
     (ZOO_LOSS_REL; float64 for the conv VAEs) and dump_outputs card
     against CPU (ZOO_OUT_REL); a reference nnetCLDNN imported and dumped
     card against CPU. (b) the demo recipe's stage 5: FDLP (K1, counted,
     then held to its plain version) of ADAPT_UTTS held-out utterances ->
     adapt_am.main of phase 6's AM against phase 13's PM (one epoch at
     ADAPT_BATCH, dev FER on phase 6's egs before and after) -> the adapted
     checkpoint reloaded -> pm_score_cli pm of it; the first-step PM loss
     card against CPU (ADAPT_LOSS_REL). (c) lifelong_decode.main over
     LIFELONG_UTTS of (b)'s utterances with phase 6's AM and a second
     seeded classifier and two
     seeded GRU VAEs (over the features, or the classifiers' outputs for
     postpm), every fusion: utterances a second, fused arks card against
     CPU (LIFELONG_REL). (d) recog_e2e.main --api cl over phase 5's and
     phase 7's models (CL_PM_SCORES, beam 10, CL_MAX_LEN) on one copy of
     each of phase 7's utterances:
     ms a step, hypotheses card against CPU, and a bf16 run whose best
     hypotheses' fused scores are finite;
  15. (a) int8 serving on phase 8's directory: quantized_bytes of the
     encoder and the device memory of the float32 and int8 models;
     make_server(int8=True) with 8 concurrent unpaced socket streams, each
     final held to an int8 OnlineASRPipeline (near-tie rule of phase 8),
     K1 counted; transcribe --int8 on two wavs; the int8 streamed memory
     card vs CPU on the same codes (INT8_MEM_ATOL) and int8 against the
     float32 offline chunked encode (INT8_VS_F32_ATOL, CTC argmax
     agreement); one round int8 against float32, in turns; the same for
     phase 10 (b)'s conformer over 5 streams. (b) the look-ahead word LM:
     a seeded 65,000-word lexicon in phase 5's letters, train_lm.main
     --unit word at its defaults for one epoch (first-step loss card vs CPU,
     1e-5), recog_e2e.main --word_lm_dir --word_lm_dict with phase 5's model
     on WORDLM_UTTS of phase 3's utterances (FDLP on K1, counted),
     max_len WORDLM_MAX_LEN, offline and
     --streaming, hypotheses card vs CPU on 2, ms a search step by part and
     the LRU hit rate. (c) forced alignment at timit_hybrid's front-end:
     phase 4's utterances through FDLP (K1, counted, then held to its plain
     version) and CMVN, a seeded 200-word lexicon over 48 phones,
     force_align.main at its defaults with ALIGN_FLAGS, one batch's DP card
     vs CPU, ali_utils convert and combine;
  16. (a) stage 0 of reverb_hybrid.json at full width (enhance_phase):
     simulate_corpus makes 8 utterances of 4-8 s at 8 channels, SNR 20 dB,
     as a data dir with clean_wav.scp / noise_wav.scp; maybe_mask_model
     trains the BLSTM mask net (513 bins, hidden 256) for one epoch,
     run_enhancement runs WPE (512/128, 10 taps, delay 3, 5 iterations) ->
     masks -> GEV + BAN + phase correction (1024/256) -> iSTFT, se_scores
     returns all eight metrics as numbers; ms a mask-net step, ms an
     utterance by part, the real-time factor, device busy; card vs CPU
     (WPE, masks, beamformed STFT up to one global phase, first-step
     loss); one chime4_hybrid utterance (6 channels, no WPE). (b)
     compute_fdlp_spectrogram at wsj_fdlp_e2e over the enhanced wavs with
     --add_noise and --add_reverb small_room (seeded noise and RIR wavs in
     a temporary working directory): K1 counted and held to its plain
     version, features card vs CPU;
  17. the port's recipe drivers (recipe_phase): (a) run_corpus at
     wsj_fdlp_e2e.json (80 bands, order 150, 1.5 s; the 12/6 transformer,
     adim 256, 4 heads, FFN 2048; the 1 x 1000 GRU RNNLM; beam 10, ctc
     0.3, lm 1.0, --jit_decode at batch 8), stages 1-5 with
     --profile_stages, on a corpus from the port's make_synth_corpus
     (--seed, train 0.125 h, dev and test 1 min, 16 kHz), cut through
     --set am.epochs=1 lm.epochs=1 decode.max_len=30: K1 counted and held
     to its plain version on stage 1's lags, each stage's seconds and peak
     memory (no stage starts with more than RECIPE_CARRY_BYTES left by the
     stages before it), the WER line, then --stage 5 again: the same
     hypotheses, no stage 1-4 file rewritten. (b) run_corpus at
     timit_hybrid.json (20 bands, order 50, 0.5 s; 3 x 512 GRU over the
     corpus's 27 classes; the lexicon's WFST decode at prior_weight 0.8;
     the 2 + 2 x 512 pm_ae, bn 64), stages 1-6 on the same corpus, cut to
     am.epochs=1 pm.epochs=1; stage 5 again with --device cpu on a copy:
     log-likelihoods within RECIPE_LL_REL of their scale, hypotheses by
     phase 9's rule. (c) recipes/demo.py at its defaults: Viterbi and
     argmax FER, K1 counted. (d) recipes/reverb_demo.py at REVERB_DEMO_ARGS:
     SE scores of noisy and enhanced audio, K1 counted at stage 4, the
     hypothesis file. (e) io/prefetch.py's prefetch_to_device on the card
     (batches in order and equal to the host's; the producer's error
     raised at the consumer) and cli/babysit.py around a command that
     crashes once, then succeeds;
  18. the parallel layer (parallel_phase), in worlds of local ranks that
     parallel/launcher.py::launch starts on this one card (gloo, whose
     exchanges go through host memory: correctness and overhead, not
     scaling) from a thread while phase 17 and then the one-process
     references run on the card: (a)
     compute_fdlp_spectrogram --data_parallel on 2 ranks over phase 3's
     32 utterances (as int16 wavs): K1 launched on each rank's rows,
     counted, and held to its plain version on them (phase 2's limits);
     rank 0's ark against the one-process CLI's over the same batches,
     each rank's rows as a batch of its own (PAR_FEAT_BUCKET; rtol 1e-3,
     atol 2e-3);
     (b) the frame- and input-sharded FDLP over a 'time' axis of 2 on 4
     full-length 60 s utterances against fdlp_spectrogram_batch on the
     card (same limits), K1 counted per rank and held to its plain
     version on a rank's block of frames; (c) train_e2e --data_parallel,
     --tensor_parallel 2, --pipeline_parallel 2 --pp_microbatches 4 (2
     ranks), --data_parallel --pipeline_parallel 2 (4 ranks) and
     --data_parallel in a 1-rank NCCL world (after an NCCL all-reduce),
     each one epoch of 2 steps from phase 7's checkpoint at dropout 0:
     first-step loss and gradient norm against the one-process step
     (1e-5, 1e-4 relative), each run's epoch_1 checkpoint's parameter
     change and Adam moments against one process's (PAR_UPDATE_REL,
     PAR_UPDATE_SHARE, PAR_MOMENT_REL) and the checkpoint loaded into the
     one-process model; (d) encode_ring over 2 ranks on 4 utterances of
     20-30 s against the offline encode (atol 1e-4), and recog_e2e
     --ring_attention 2 token-identical to the plain CLI; (e) train_am
     --data_parallel (the 3 x 512 GRU) and --arch curl --expert_parallel
     2 over phase 6's egs, first step against one process (same limits).
     Each path's ms and the share of it spent in exchanges are logged;
  19. one JSON line describing every kernel of the port (`launches` is the
     main path's count: K1's on the hybrid slice, K2's on the e2e one,
     K3's over phase 6's train_am.main; `launches_by_path` each path's:
     K2's over the e2e, incremental, bf16, conformer and word-LM searches
     and recog_e2e's --jit_decode and --streaming final beam, every one at
     least 1, and beside them the CUDA graphs each of those searches
     captured (`search_graph_captures_by_path`: one a new search shape, none
     on the word-LM's eager loop); K3's over the hybrid training, the RNNLM
     stage, the hybrid posteriors, the MFCC training, the PM stage, the zoo,
     adaptation, lifelong decoding, alignment and each rank of train_am
     --data_parallel and --expert_parallel; the other numbers phase 2's
     kernel_table's);
  20. the run's time, the card's name and power limit again, then the last
     line: {"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark.common import (
    H100_BYTES_PER_S,
    H100_F32_FLOPS,
    k1_bound_s,
    k1_work,
    random_transcript,
    speechlike_signals,
)
from speech_recognition_tools_tpu_torch.decode.beam_jit import beam_search_encoded
from speech_recognition_tools_tpu_torch.decode.ctc_prefix import ctc_prefix_scores
from speech_recognition_tools_tpu_torch.ops.gru_scan import gru_scan

# K1 against its plain version on real FDLP lags: allclose(rtol=atol=TOL)
# and, per cepstral coefficient n, max|err_n| <= REL * mean|c_n|
MAIN_PATH_TOL, MAIN_PATH_REL = 1e-3, 1e-2
NEAR_PERIODIC_TOL, NEAR_PERIODIC_REL = 5e-3, 0.15
NEAR_PERIODIC_REVERB_REL = 0.2  # the same lags at lim = 450 (same TOL)

# the e2e slice (recipes/configs/wsj_fdlp_e2e.json): its model (:17-24;
# vocab 52 is the WSJ character set the defaults carry), RNNLM (:41-45,
# embedded at adim), decode (:35-40); max_len is beam_search_jit's default
# (the recog_e2e CLI's is 200); and the limit on
# max|CTC logp(K1 features) - CTC logp(plain-backend features)| over valid
# frames: ~4x the first reading recorded in PERF.md (3.0e-4)
E2E_AM = dict(vocab_size=52, adim=256, aheads=4, elayers=12, eunits=2048, dlayers=6,
              dunits=2048)
E2E_LM_HIDDEN = 1000
E2E_BEAM = dict(beam_size=10, ctc_weight=0.3, penalty=0.0, lm_weight=1.0)
E2E_MAX_LEN = 100
# cut for time: the card-vs-CPU search on 2 utterances (from 100)
E2E_CPU_MAX_LEN = 50
E2E_CTC_TOL = 1.2e-3

# training (phases 6-7): timit_hybrid's am section and wsj_fdlp_e2e's
# (:17-34), at full width; two epochs of two batches each
HYBRID_TRAIN = dict(num_layers=3, hidden_dim=512, optimizer="adam", learning_rate=1e-3,
                    lrr=0.5, lr_tol=0.0, clip_thresh=1.0, batch_size=16, epochs=2)
HYBRID_CLASSES = 3376
E2E_TRAIN = dict(mtlalpha=0.3, lsm_weight=0.1, dropout=0.1, warmup_steps=25000,
                 transformer_lr=10.0, grad_clip=5.0, batch_size=32, epochs=2,
                 average_last=2)
E2E_TRAIN_DECODE_LEN = 50  # max_len of the final_avg checkpoint's one search

# online serving (phase 8): the recipes' streaming setting
# (recipes/streaming_migration_ab.sh:37,48), srt-serve's defaults
# (--max_streams 8, --defer_ms 30) and serve_client's 0.25 s messages; the
# CTC head's blank logit is raised by SERVE_BLANK_BIAS so that, as in a
# trained CTC model, most frames are blank and pauses endpoint; a
# greedy-CTC mismatch is allowed only at a frame whose top two logits are
# within SERVE_NEAR_TIE
SERVE_CHUNK = dict(attn_chunk=16, attn_left_chunks=4)
SERVE_STREAMS = 8
SERVE_DEFER_S = 0.03
SERVE_PUSH_S = 0.25
SERVE_BLANK_BIAS = 2.0
SERVE_NEAR_TIE = 1e-4
SERVE_FEAT_TOL = dict(rtol=1e-3, atol=2e-3)  # phase 3's limits
SERVE_MEM_ATOL = 1e-4
SERVE_RECOG_UTTS, SERVE_RECOG_MAX_LEN = 4, 25  # max_len cut from 50 for time

# the LM stage and the hybrid decode end (phase 9): wsj_fdlp_e2e's RNNLM
# (recipes/configs/wsj_fdlp_e2e.json "lm": 1 x 1000 GRU, embed 256) with
# train_lm's defaults (batch 64, bptt_len 128, lr 1e-3) for one epoch of
# LM_TEXTS transcripts (one sequence each: 8 batches); timit_hybrid's decode
# (recipes/configs/timit_hybrid.json "decode": prior_weight 0.8;
# run_corpus.py's build-graph and decode defaults: states_per_phone 1,
# acoustic_scale 0.1, beam 16; the decode CLI's max_active 7000) over a
# 3-gram of the decode set's transcripts, words of DECODE_WORDS with 2-4
# random pdf ids each
LM_TRAIN = dict(embed_dim=256, hidden=1000, layers=1, batch_size=64, bptt_len=128,
                learning_rate=1e-3, epochs=1)
LM_TEXTS, LM_TEXT_CHARS = 512, (60, 126)
LM_STEP_CPU_SEQS = 16  # the card-vs-CPU step: the first 16 sequences of a batch
LM_SEARCH_MAX_LEN = 30
DECODE_UTTS, DECODE_WORDS = 12, 40
HYBRID_DECODE = dict(acoustic_scale=0.1, beam=16.0, max_active=7000)
DECODE_PRIOR_WEIGHT = 0.8
DECODE_LL_ATOL, DECODE_COST_TOL = 1e-4, 1e-3

# phase 10 (a): wsj_hybrid's front-end (recipes/configs/wsj_hybrid.json
# "frontend" with the compute_mfcc CLI's defaults: 30 filters, 0.02 s, nfft
# 1024) and its am section (4 x 300 GRU, 3,376 classes, batch 64, Adam)
# for one epoch of 2 batches (phase 3's 32 utterances, each four times);
# card against CPU features: allclose(rtol, atol) over every valid frame
# (float32 FFTs and GEMMs summed in other orders, then log10)
MFCC_FLAGS = dict(srate=16000, nfilters=30, fduration=0.02, frate=100, nfft=1024)
MFCC_TRAIN = dict(num_layers=4, hidden_dim=300, optimizer="adam", learning_rate=1e-3,
                  batch_size=64, epochs=1)
MFCC_CLASSES, MFCC_CONTEXT, MFCC_COPIES = 3376, 4, 4
# the frames of the card-vs-CPU step and of the profiled step (the CPU GRU
# loop, and the profiler's pass over ~190 launches a frame, are slow)
MFCC_STEP_FRAMES = 150
MFCC_TOL = dict(rtol=1e-4, atol=1e-3)

# phase 10 (b): wsj_fdlp_conformer_e2e.json's model (:17-35) and decode
# (:36-41), with E2E_AM's vocabulary; the streaming setting of phase 8; one
# epoch of phase 7's two batches of 32
CONF_AM = dict(E2E_AM, encoder_type="conformer", conv_kernel=15)
CONF_MAX_LEN = 50
CONF_TRAIN = dict(E2E_TRAIN, epochs=1, average_last=1)
CONF_STREAMS, CONF_SLOTS = 5, 4

# phase 11 (a): wsj_fdlp_e2e's front-end at precision 'high' (float64 from
# the window multiply on): card against CPU on HIGH_CPU_UTTS utterances and
# 'blocked:15' against 'scan' within HIGH_TOL (the bound the CPU tests hold
# the high path to against the JAX package), both at float64 I/O (at
# float32 I/O their differences vanish in the cast); high against fast (K1,
# the f32 ridge): max|diff| and its 99.9th percentile within
# HIGH_VS_FAST_MAX and HIGH_VS_FAST_P999, about 4x the first card readings
# (1.44 and 0.059)
HIGH_CPU_UTTS = 4
HIGH_TOL = 1e-6
HIGH_VS_FAST_MAX, HIGH_VS_FAST_P999 = 6.0, 0.25
# phase 11 (b): compute_modulation_spectrum at its CLI defaults (15 bands,
# order 50, coefficients 5-30, 0.5 s windows at 100 Hz, batch 8); card
# against CPU on MODSPEC_CPU_UTTS utterances, |err| over the features' scale
# (their 99.9th percentile of |value|): real float32 features within
# MODSPEC_TOL everywhere. The complex64 chain (both packages: no ridge, and
# order-50 Hermitian Levinson in float32) degenerates on a small share of
# narrowband rows, whose values are rounding noise that no two summation
# orders share (on the CPU the JAX package's own float32 features stray
# past 5% of the scale from its float64 ones on 0.2% of the entries, the
# port's on 0.6%): complex features are held finite, within
# MODSPEC_COMPLEX_TOL on all but MODSPEC_COMPLEX_SHARE of the entries, and
# in float64 (no degenerate rows) card against CPU within MODSPEC_F64_TOL.
# K1 against its plain version on the path's own lags: MODSPEC_K1_TOL and
# MODSPEC_K1_REL as MAIN_PATH_TOL and MAIN_PATH_REL, about 4x the first
# readings (1.05e-3 and 1.38e-2: these rows are worse conditioned than the
# hybrid main path's)
MODSPEC_CPU_UTTS = 4
MODSPEC_K1_TOL, MODSPEC_K1_REL = 4e-3, 5e-2
MODSPEC_TOL = 1e-2
MODSPEC_COMPLEX_TOL = 5e-2
MODSPEC_COMPLEX_SHARE = 2e-2
MODSPEC_F64_TOL = 1e-6
MODSPEC_RUNS = {"default": [], "unity_gain": ["--set_unity_gain"],
                "complex": ["--complex_modulation"],
                "complex_abs": ["--complex_modulation", "--absolute_value"]}
# phase 11 (c): the incremental (KV-cached) search against the full-prefix
# one on phase 5's model: best scores within INCR_SCORE_REL, relative
INCR_SCORE_REL = 1e-4
INCR_MAX_LEN = 50  # cut from phase 5's 100 for time

# phase 12 (a): bf16 mixed precision (recipes/precision_ab.sh:33,
# streaming_migration_ab.sh:50) on phase 5's model and phase 3's batch.
# Limits, relative to the reference tensor's largest magnitude over valid
# frames: bf16 against float32 CTC logits within BF16_VS_F32_REL (the
# rounding of 12 bf16 encoder layers: about 4x the port's readings on the
# CPU at 12/6 layers and adim 64 with seeded weights, 1.2e-2 for the
# transformer and 1.4e-2 for the conformer); bf16 on the card against bf16 on the CPU
# within BF16_DEVICE_REL, and the streamed bf16 memory against the offline
# bf16 chunked encode within BF16_STREAM_REL (two orders of bf16 rounding;
# the CPU tests hold port against JAX at 2.5e-2 and streamed against
# offline at 1e-2 for 2 layers)
# the bf16 and float32 searches run to BF16_MAX_LEN (phase 5 times max_len
# 100 in float32; cut from 50 for time)
BF16_MAX_LEN = 25
BF16_CPU_UTTS, BF16_CPU_MAX_LEN = 2, 25  # cut from 4 and 50 for time
BF16_VS_F32_REL = 6e-2
BF16_DEVICE_REL = 5e-2
BF16_STREAM_REL = 5e-2
BF16_STREAMS = 5
BF16_TRAIN_STEPS = 3
# phase 12 (b): phase 9's LM stage with the lstm cell (ESPnet's default)
# at wsj_fdlp_e2e's LM width; the fused search card against CPU on
# LSTM_SEARCH_UTTS utterances at max_len LM_SEARCH_MAX_LEN
LSTM_SEARCH_UTTS = 4
# phase 12 (c): reference checkpoints built here in the source toolkits'
# layouts at wsj_fdlp_e2e's widths (ESPnet e2e transformer; DefaultRNNLM
# 1 x 1000 LSTM, embed 256) and timit_hybrid's (nnetRNN 3 x 512 GRU, 3,376
# classes), imported, then held against their torch reconstructions on the
# card in float32: the e2e model's encoder output, CTC and decoder logits
# within IMPORT_E2E_ATOL (12 + 6 layers; the CPU tests hold 2 layers to
# 6e-5), the LM's logits within IMPORT_LM_ATOL, the hybrid model's
# dump_outputs logits within IMPORT_HYB_ATOL (cuDNN's GRU against the
# port's over the utterance; phase 4 holds the port's GRU card vs CPU to
# 1e-4)
IMPORT_E2E_ATOL, IMPORT_LM_ATOL, IMPORT_HYB_ATOL = 1e-3, 1e-4, 1e-3
IMPORT_UTTS, IMPORT_RECOG_MAX_LEN = 2, 50
# phase 13 (a): the hybrid recipes' stage 6 (recipes/run_corpus.py:884-909)
# at timit_hybrid's "pm" block (timit_hybrid.json:33-39): PM_UTTS held-out
# utterances of 1-2.5 s through phase 6's AM; each of their log-likelihood
# matrices twice in the PM egs, so that one epoch is 2 batches of 32
PM_TRAIN = dict(num_layers=2, num_layers_dec=2, hidden_dim=512, bn_dim=64, batch_size=32,
                epochs=1)
PM_UTTS = 32
# phase 13 (b): every other arch of the recurrent half at train_am's
# defaults over phase 6's egs (each utterance twice: 2 batches of 32), with
# the depth cut from train_am's 3 layers to ZOO_B_LAYERS (2 to make room
# for phase 16, 1 to keep the run inside its time limit)
ZOO_TRAIN = dict(num_layers=3, num_layers_dec=1, hidden_dim=512, bn_dim=64, comp_num=2,
                 batch_size=32, epochs=1)
ZOO_B_LAYERS = 1
ZOO_MAX_FRAMES = 200  # each training utterance's first 2 s (cut for time)
# card against CPU on the ZOO_CPU_UTTS shortest utterances, the same weights
# and the same noise (drawn on the CPU): the first-step loss within
# ZOO_LOSS_REL (phase 6's limit for the rnn step), dump_outputs and the PM
# scores within ZOO_OUT_REL of their scale (the CPU tests hold the port to
# JAX at 1e-5 of the scale at 2 layers; phase 4 holds the 3 x 512 GRU's
# logits card vs CPU to 1e-4)
ZOO_CPU_UTTS = 4
ZOO_LOSS_REL, ZOO_OUT_REL = 1e-5, 1e-4

# phase 14 (a): the conv half of the zoo at train_am's defaults (ZOO_TRAIN)
# over phase 13's doubled timit_hybrid egs; modnet_sigmoid's training goes
# NaN on padded batches in both packages, and the conv VAEs may diverge
# (ROADMAP Queue 3): their histories are logged (modnet_sigmoid's held to
# NaN), their first-step losses and dumps held to the CPU's
CONV_ARCHS = ["cnn", "cldnn", "vae_cnn", "vae_cnn_pool", "rs_vae", "modnet", "modnet_sigmoid"]
# phase 14 (a): the reference nnetCLDNN imported (timit_hybrid input, 64
# conv channels, 3 x 512 LSTM, 512 -> 3,376 DNN)
CLDNN_IMPORT = dict(channels=64, hidden=512, lstm_layers=3)
# phase 14 (b): adapt_am of phase 6's AM against phase 13's PM on ADAPT_UTTS
# held-out timit_hybrid utterances of 1-2.5 s, one epoch at batch 16; the
# first-step PM loss card against CPU within ADAPT_LOSS_REL
ADAPT_UTTS, ADAPT_BATCH, ADAPT_LOSS_REL = 32, 16, 1e-5
# K1 against its plain version on the adaptation set's lags: allclose
# within MAIN_PATH_TOL, and per coefficient within MODSPEC_K1_REL, the
# limit for lags with ill-conditioned rows. This batch exceeds
# MAIN_PATH_REL (1.7e-2 on the H100): there both float32 versions sit as
# far from the float64 plain version, which the phase logs beside it
ADAPT_K1_REL = MODSPEC_K1_REL
# phase 14 (c): lifelong_decode's fusions over (b)'s egs, fused arks card vs
# CPU on ZOO_CPU_UTTS utterances within LIFELONG_REL of their scale
LIFELONG_RUNS = {"powerset": ["dp"], "incremental": ["mm"], "perframe": ["dp"],
                 "autoT": ["lowent"], "postpm": ["dp", "--pm_on", "posteriors"]}
LIFELONG_REL = 1e-4
LIFELONG_UTTS = 16  # the first of (b)'s utterances (cut from 32 for time)
# phase 14 (d): recog_e2e --api cl over phase 5's and phase 7's models (task
# weights exp(300 pm) / sum = 0.953, 0.047), beam 10; searches on random
# weights never end on eos, so CL_MAX_LEN sets the phase's time
CL_PM_SCORES, CL_MAX_LEN, CL_CPU_UTTS = "0.02,0.01", 12, 2
# phase 15 (a): int8 serving on phase 8's and phase 10 (b)'s directories: the
# int8 streamed memory card vs CPU on the same codes (phase 8's float32
# limit), and int8 against the float32 offline chunked encode
INT8_MEM_ATOL = SERVE_MEM_ATOL
# ~4x the first readings on the H100 (max|diff| 7.3e-2 transformer, 1.6e-1
# conformer; CTC argmax agreement 97.6% and 99.4%; PERF.md §6)
INT8_VS_F32_ATOL, INT8_CTC_AGREE = 0.65, 0.9
INT8_CONF_STREAMS = 5
# phase 15 (b): a word LM over the reference's lm_vocabsize (65,000,
# e2e/wsj/run_fdlp_e1.sh:39, <eos> and <unk> included), transcripts of 8-16
# words, phase 5's model on WORDLM_UTTS of phase 3's utterances, beam 10;
# the searches cut from 8 utterances at max_len 50 to make room for phase 16,
# then to max_len 15 to keep the run inside its time limit
WORDLM_VOCAB = 65000
WORDLM_TEXT_WORDS = (8, 17)
WORDLM_UTTS, WORDLM_MAX_LEN, WORDLM_CPU_UTTS = 4, 15, 2
# phase 15 (c): TIMIT's phone set size, a seeded 200-word lexicon, and the
# Kaldi topology tier (3-state phones, 5-state silence, word-position
# silence) at force_align's CLI defaults otherwise; the AM's epochs an
# iteration cut from the default 10 to 5 to make room for phase 18
ALIGN_PHONES, ALIGN_WORDS, ALIGN_EPOCHS = 48, 200, 5
ALIGN_FLAGS = ["--states_per_phone", "3", "--silence_phone", "0", "--silence_states", "5",
               "--wpd_silence", "--epochs", str(ALIGN_EPOCHS)]
# phase 16 (a): stage 0 of recipes/configs/reverb_hybrid.json (:9-13, read
# from the file: WPE 512/128, taps 10, delay 3, 5 iterations; GEV + BAN over
# 1024/256, phase correction on by default; the BLSTM mask net, 513 bins,
# hidden 256) on ENH_UTTS utterances of 4-8 s, ENH_CHANNELS channels, made
# by dsp/simulate.py::simulate_corpus at the reference's
# Generate_mcTrainData_cut.m SNRdB; the mask net trained for ENH_MASK_EPOCHS
# (cut from the config's default 8); se_scores with all eight metrics; one
# utterance of chime4_hybrid.json:9-13 (6 channels, no WPE). Card against
# CPU, on the shortest utterance: the WPE output within ENH_WPE_REL of its
# peak (the pipeline's WPE solves its 80 x 80 systems in complex128, then
# rounds to float32), the beamformed STFT on the same STFT and masks in
# complex128 after one global phase within ENH_BF_REL of its peak (8 x 8
# Cholesky and eigh per bin on two libraries), mask-net masks within
# ENH_MASK_ATOL and its first-step loss within ENH_LOSS_REL (float32 LSTM
# loops over ~250-500 frames)
ENH_UTTS, ENH_CHANNELS, ENH_SNR_DB, ENH_MASK_EPOCHS = 8, 8, 20.0, 1
ENH_SECONDS = (4.0, 8.0)
ENH_METRICS = ["pesq", "stoi", "estoi", "srmr", "fwsegsnr", "cepsdist", "lpcllr", "sdr"]
ENH_WPE_REL, ENH_BF_REL, ENH_MASK_ATOL, ENH_LOSS_REL = 1e-5, 1e-6, 1e-4, 1e-5
# phase 16 (b): the featgen CLI at wsj_fdlp_e2e's front-end over (a)'s
# enhanced wavs with --add_noise <seeded noise>,AUG_SNR --add_reverb
# small_room; features card against CPU on AUG_CPU_UTTS utterances at
# phase 3's limits
AUG_SNR, AUG_CPU_UTTS = 10, 2
WSJ_FDLP_FLAGS = ["--nfilters", "80", "--order", "150", "--fduration", "1.5",
                  "--coeff_num", "100", "--coeff_range", "1,100"]

# phase 17: the port's recipe drivers on a corpus from the port's
# make_synth_corpus (16 kHz; at --seed 0 train 0.125 h is 69 utterances, 3
# batches of 32; dev and test 1 min each); run_corpus at wsj_fdlp_e2e and
# timit_hybrid, read from recipes/configs, with these cuts through --set;
# the hybrid stage 5 card against CPU at phase 9's limits (log-likelihoods
# within RECIPE_LL_REL of their scale, WFST hypotheses identical or
# DECODE_COST_TOL); a stage may start with at most RECIPE_CARRY_BYTES in
# use beyond what the card held before the run (the featgen's cached
# constants, 7.4 MiB at wsj_fdlp_e2e, and the libraries' state: 10-26 MiB
# on an H100 80GB HBM3), and each stage after the first with at most
# RECIPE_GROWTH_BYTES more than the second (0.5-0.8 MiB there): no model
# stays, the smallest being timit_hybrid's AM at 15 MiB; the reverb
# demo at its own widths and its default 8 mask-net epochs (one epoch's
# binary noise masks leave bins empty and its GEV + BAN output NaN,
# ROADMAP Queue 3)
RECIPE_CORPUS = ["--train_hours", "0.125", "--dev_minutes", "1", "--test_minutes", "1"]
RECIPE_E2E_CUTS = ["am.epochs=1", "lm.epochs=1", "decode.max_len=30"]
RECIPE_HYB_CUTS = ["am.epochs=1", "pm.epochs=1"]
RECIPE_LL_REL = 1e-4
# K1 against its plain version on stage 1's lags of that corpus (each phone
# two partials over AR noise: near-periodic, order-150 rows worse
# conditioned than phase 2's): ~4x the first reading (1.05e-2 and 6.4e-2
# at wsj_fdlp_e2e on an H100 80GB HBM3 at 700 W; PERF.md §6)
RECIPE_K1_TOL, RECIPE_K1_REL = 4e-2, 0.25
RECIPE_CARRY_BYTES, RECIPE_GROWTH_BYTES = 32 << 20, 8 << 20
REVERB_DEMO_ARGS = ["--num_utts", "5", "--e2e_epochs", "1"]

# (order, coeff_num) of the front-ends in recipes/configs: wsj/chime4/
# conformer e2e, timit_hybrid, reverb
CONFIG_SHAPES = [(150, 100), (50, 50), (150, 450)]
# K1's swept shapes: featgen's and the e2e front-end's rows, the hybrid
# main path's, and the reverb front-end's at featgen's row count
SWEPT_SHAPES = [(23040, 150, 100), (10240, 50, 50), (23040, 150, 450)]


def log(msg):
    print(msg, flush=True)


def phase_done(n, t_phase, t_run):
    """Log phase n's seconds, and mark its end on stderr with the seconds
    since the start, so that the end of stderr says how far a run got."""
    now = time.perf_counter()
    log(f"[phase{n}] {now - t_phase:.2f} s")
    print(f"chip_smoke: phase {n} done, {now - t_run:.1f} s from the start", file=sys.stderr,
          flush=True)


def cuda_ms(fn, reps, repeats=5, warmup=2):
    """Median per-call time of fn() in ms, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def graph_ms(fn, reps=20, repeats=5):
    """Median device time in ms of one fn() call: `reps` calls captured in
    one CUDA graph, replayed between CUDA events, so that the host's
    per-call overhead (which exceeds a short kernel) stays out of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=1, repeats=repeats) / reps
    del graph
    return ms


def wall_s(fn, repeats=3, warmup=True):
    """Median wall time in s of fn() ending in a synchronize (after one
    warm-up call, unless the caller has just run the same work), and the
    last result."""
    if warmup:
        fn()
        torch.cuda.synchronize()
    out = None
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def span_seconds(fn):
    """fn() under a profiler (device activities on a card, host ones
    without), so that the port's spans (utils/profiling.py::span) record.
    Returns (fn's result, {span name: (host seconds summed, spans)}) of the
    spans fn recorded; a span does not synchronise, so a part's seconds are
    its launches, and a `.wait` / `.readback` span's the host's wait."""
    from torch.profiler import ProfilerActivity, profile

    from speech_recognition_tools_tpu_torch.utils.profiling import span_records

    before = max((r.id for r in span_records()), default=0)
    with profile(activities=[ProfilerActivity.CUDA] if torch.cuda.is_available()
                 else [ProfilerActivity.CPU]):
        out = fn()
    parts = {}
    for r in span_records():
        if r.id > before:
            secs, count = parts.get(r.name, (0.0, 0))
            parts[r.name] = (secs + (r.end_ns - r.start_ns) / 1e9, count + 1)
    return out, parts


def device_breakdown(tag, fn, top=8):
    """One profiled call of fn(): device busy share of the wall time and the
    kernels that took the most device time (torch.profiler / CUPTI).
    Returns (wall us, device busy us, device activities), or None when the
    profiler saw no device time.

    Only the device is traced: recording every host op as well costs the
    host more during the call and, for calls of ~10^4-10^5 launches, tens
    of seconds of parsing after it. Should a tracer show no device time
    that way, the call is profiled again with the host ops."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for e in prof.key_averages():
            # device-side activities only (kernels, copies); the aten rows
            # above them carry the same time again, and the profiler's own
            # buffer request is not work
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.key == "Activity Buffer Request"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((us, e.count, e.key))
        if rows:
            break
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {tag}: the profiler saw no device time (not measured)")
        return None
    log(f"[profile] {tag}: wall {wall_us / 1e3:.2f} ms (profiled), device busy "
        f"{busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f}%, {sum(r[1] for r in rows)} "
        f"device activities")
    for us, count, name in sorted(rows, reverse=True)[:top]:
        log(f"[profile]   {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{count:<6d} {name[:90]}")
    return wall_us, busy, sum(r[1] for r in rows)


def bound_ms(flops, nbytes):
    """The least time in ms the H100 could take for `flops` float32
    operations and `nbytes` bytes of DRAM traffic, and which bounds it."""
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


class Launches:
    """One kernel's launches by path, for phase 19's kernels line: `reset()`
    sets the kernel function's `.launches` counter (or the counter `attr`)
    to 0 before a path runs, `read(path)` right after it keeps the count
    under `by_path[path]`. A path launches the kernel at least `least`
    times; where `want` says how many, exactly that many."""

    def __init__(self, fn, least, attr="launches"):
        self.fn, self.least, self.attr, self.by_path = fn, least, attr, {}

    def reset(self):
        setattr(self.fn, self.attr, 0)

    def read(self, path, want=None):
        n = getattr(self.fn, self.attr)
        assert n >= self.least, f"the {path} path counted {self.fn.__name__}.{self.attr} {n}"
        assert want is None or n == want, (path, n, want)
        self.by_path[path] = n
        return n


# every search path has to launch K2; that every GRU model runs on K3 is
# tests/test_torch_gru_kernel.py::test_card_every_gru_model_trains_through_k3's
K2 = Launches(ctc_prefix_scores, least=1)
K3 = Launches(gru_scan, least=0)
# the CUDA graphs each search path captures (decode/beam_jit.py)
GRAPHS = Launches(beam_search_encoded, least=0, attr="graph_captures")


def search_steps(toks):
    """Steps a beam search ran, from its (B, K, max_len + 1) tokens: every
    step fills its column in every row, finished rows included."""
    return int((toks[0, 0] >= 0).sum()) - 1


def k2_work(B, K, V, T):
    """(operations, DRAM bytes) of K2 at (B, K, V, T): ~25 operations a
    chain and frame; logp and r_prev read once, r_new (2 T B K V floats),
    psi and full written once, the int64 inputs read once."""
    nbytes = 4 * (B * T * V + B * K * T * 2 + 2 * T * B * K * V + 2 * B * K * V)
    nbytes += 8 * (B + 2 * B * K)
    return 25 * B * K * V * T, nbytes


def k3_work(B, T, H, lengths):
    """(flops, bytes) of K3's forward and of its backward at (B, T, H)
    over the valid frames: the recurrent product 2 3H H a valid frame each
    way (the gate algebra's ~30 operations a unit are under 1%); bytes read
    or written once: forward xi (valid frames), y (all), the gates (4H,
    valid), W_hh; backward dy, h_{t-1} and the gates (valid), dxi and dhh
    (all), W_hh."""
    valid = int(sum(min(max(int(n), 0), T) for n in lengths))
    flops = 2 * 3 * H * H * valid
    fwd = 4 * (valid * 3 * H + B * T * H + valid * 4 * H + 3 * H * H)
    bwd = 4 * (valid * 6 * H + B * T * 6 * H + 3 * H * H)
    return (flops, fwd), (flops, bwd)


def cepstra_gap(got, want):
    """K1's measure, phase 2's: the least t for which allclose(rtol=t,
    atol=t) holds, and the largest gap."""
    (g,), (w,) = got, want
    err = (g - w).abs()
    return (err / (1 + w.abs())).max().item(), err.max().item()


def prefix_gap(got, want):
    """K2's measure, tests/test_torch_ctc_prefix_kernel.py's: element by
    element, the largest gap relative to the plain version's entry, and the
    largest gap, over its finite entries; its NEG_INF entries have to be
    NEG_INF in place, and the rest finite, or both gaps are inf."""
    from speech_recognition_tools_tpu_torch.decode.ctc_prefix import NEG_INF

    rel = err = 0.0
    for g, w in zip(got, want):
        dead = w == NEG_INF
        live = g[~dead]
        if not torch.equal(g == NEG_INF, dead) or not (live.isfinite() & (live > -1e29)).all():
            return float("inf"), float("inf")
        e = (live - w[~dead]).abs()
        rel = max(rel, (e / w[~dead].abs().clamp_min(1e-30)).max().item())
        err = max(err, e.max().item())
    return rel, err


def scale_gap(got, want):
    """K3's measure: each tensor's largest gap over its largest entry, the
    worst of them, and the largest gap."""
    gaps = [(g - w).abs().max() for g, w in zip(got, want)]
    return (max((d / w.abs().max()).item() for d, w in zip(gaps, want)),
            max(d.item() for d in gaps))


@dataclasses.dataclass
class KernelCase:
    """One kernel alone at its cell's shape, for kernel_table. `call` runs
    the kernel through the port's function and `plain` its plain version,
    each on the same inputs, returning a list of output tensors; `gap(got,
    want)` gives their (relative, absolute) gaps in the kernel's measure,
    the relative one held to `limit`. `launch` is the bare kernel launch,
    `work` its (operations, DRAM bytes); `backward` and `backward_work`
    the same for a backward kernel; `library` a library call that computes
    the same at the same shape, where one does."""

    shape: list
    call: object
    plain: object
    gap: object
    limit: float
    launch: object
    work: tuple
    library: object = None
    backward: object = None
    backward_work: tuple = None
    graph_reps: int = 20


# the kernels alone, each at its cell's shape: K1 at the rows of a batch
# of wsj_fdlp_e2e.featgen (order 150, 100 cepstra); K2 at the
# wsj_fdlp_e2e.decode cell's longest batch (B, T) with valid lengths
# 100-303; K3 at the timit_hybrid.train cell's longest batch (B, T, H): 32
# utterances of 5.5-6 s (K3_CELL_LENS frames) in 32-frame buckets
K1_CELL = (23040, 150, 100)
K2_CELL_BT = (8, 303)
K3_CELL = (32, 608, 512)
K3_CELL_LENS = (551, 600)


def k1_case(gen, dev):
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )

    P, order, lim = K1_CELL
    r = ar_lags(P, order, gen, dev)
    launch = lambda: lpc_cepstra(r, order, lim)  # noqa: E731
    # no single PyTorch call computes Levinson-Durbin + LPC cepstra
    return KernelCase(shape=list(K1_CELL), call=lambda: [launch()],
                      plain=lambda: [lpc_cepstra_reference(r, order, lim)], gap=cepstra_gap,
                      limit=1e-4, launch=launch, work=k1_work(P, order, lim))


def k2_case(gen, dev):
    """K2 on the inputs of its card tests (a beam of 10 prefixes chained
    through the plain version, one of them impossible) at the cell's
    shape. F.ctc_loss sums over every alignment of one whole sequence, not
    the prefix scores of every extension of a beam: no library call."""
    from speech_recognition_tools_tpu_torch.decode.ctc_prefix import ctc_prefix_scores_reference

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_ctc_prefix_kernel import PREFIXES, V, prefix_inputs

    (B, T), K = K2_CELL_BT, len(PREFIXES) + 1
    assert (K, V) == (E2E_BEAM["beam_size"], E2E_AM["vocab_size"])
    args = prefix_inputs(B, T, torch.linspace(100, T, B).round().long().tolist(), 2, dev)
    launch = lambda: ctc_prefix_scores(*args)  # noqa: E731
    return KernelCase(shape=[B, K, V, T], call=lambda: list(launch()),
                      plain=lambda: list(ctc_prefix_scores_reference(*args)), gap=prefix_gap,
                      limit=1e-5, launch=launch, work=k2_work(B, K, V, T))


def k3_case(gen, dev):
    """K3 in a later layer (D = H) at the cell's shape: `call` a layer's
    forward and backward through autograd (dW_hh's product included), its
    output and its four gradients; the forward launch storing the gates
    for the backward, and the backward launch; torch.nn.GRU (cuDNN)
    forward and backward over the packed batch, a yardstick the port
    never calls."""
    from speech_recognition_tools_tpu_torch.models.recurrent import MaskedGRULayer
    from speech_recognition_tools_tpu_torch.ops import gru_scan as k3

    B, T, H = K3_CELL
    lengths = torch.linspace(*K3_CELL_LENS, B).round().long().tolist()
    lens = torch.as_tensor(lengths, device=dev)
    layer = MaskedGRULayer(H, H, device=dev)
    layer.reset_parameters(gen)
    x = torch.randn(B, T, H, generator=gen).to(dev)
    dy = torch.randn(B, T, H, generator=gen).to(dev)

    def layer_step(scan):
        for p in layer.parameters():
            p.grad = None
        xi = torch.nn.functional.linear(x, layer.weight_ih, layer.bias_ih)
        y = scan(xi, layer.weight_hh, layer.bias_hn, lens)
        (y * dy).sum().backward()
        return [y.detach()] + [p.grad for p in layer.parameters()]

    cudnn = torch.nn.GRU(H, H, batch_first=True, device=dev)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens.cpu(), batch_first=True,
                                                     enforce_sorted=False)
    g_out = torch.randn(packed.data.shape, generator=gen).to(dev)

    def library():
        cudnn.zero_grad(set_to_none=True)
        out, _ = cudnn(packed)
        torch.autograd.backward(out.data, g_out)

    xi = torch.randn(B, T, 3 * H, generator=gen).to(dev)
    w, b = layer.weight_hh.detach(), layer.bias_hn.detach()
    y, gates = k3._kernel_forward(xi, w, b, lens, True)
    fwd, bwd = k3_work(B, T, H, lengths)
    return KernelCase(shape=[B, T, H], call=lambda: layer_step(k3.gru_scan),
                      plain=lambda: layer_step(k3.gru_scan_reference), gap=scale_gap,
                      limit=2e-5, launch=lambda: k3._kernel_forward(xi, w, b, lens, True),
                      work=fwd, library=library,
                      backward=lambda: k3._kernel_backward(dy, y, gates, w, lens),
                      backward_work=bwd, graph_reps=5)


def kernel_table(gen, dev):
    """Each kernel alone at its cell's shape, one row of PERF.md §6's kernel
    table: its output against the plain version's in its own measure
    (max_rel_err, asserted within its limit, and max_abs_err); its bare
    launches' device ms by CUDA-graph replay beside the H100 bound of
    their work and its share; the port's call (call_ms; for K3 a layer
    through autograd), the plain version's and the library's ms by CUDA
    events. Returns {kernel: that row}, the kernels line's numbers."""
    table = {}
    for name, case in (("lpc_cepstra", k1_case), ("ctc_prefix", k2_case),
                       ("gru_scan", k3_case)):
        c = case(gen, dev)
        got = [t.clone() for t in c.call()]
        rel, err = c.gap(got, c.plain())
        assert rel <= c.limit, f"{name} at {c.shape}: relative gap {rel} over {c.limit}"
        row = dict(shape=c.shape, max_rel_err=rel, max_abs_err=err)
        for prefix, fn, work in (("", c.launch, c.work),
                                 ("backward_", c.backward, c.backward_work)):
            if fn is not None:
                ms = graph_ms(fn, reps=c.graph_reps)
                bound, by = bound_ms(*work)
                row.update({f"{prefix}ms": ms, f"{prefix}bound_ms": bound,
                            f"{prefix}bound_by": by, f"{prefix}share": bound / ms})
        row["call_ms"] = cuda_ms(c.call, reps=3)
        row["plain_ms"] = cuda_ms(c.plain, reps=1, repeats=3)
        row["library_ms"] = None if c.library is None else cuda_ms(c.library, reps=3)
        log(f"[kernels] {name} at {tuple(c.shape)} (limit {c.limit}): " + ", ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items() if k != "shape"))
        table[name] = row
    return table


def cep_agreement(tag, got, ref):
    """Kernel-vs-plain agreement on (P, lim) cepstra, printed per
    coefficient n as the typical |c_n| (mean over rows) beside the largest
    |err_n| over rows. Returns (max |err|, the least t for which
    allclose(rtol=t, atol=t) holds, the worst max|err_n| / mean|c_n|)."""
    err = (got - ref).abs()
    typ = ref.abs().mean(0)
    per_n = err.amax(0)
    rel = per_n / typ.clamp_min(1e-30)
    t_need = (err / (1 + ref.abs())).max().item()
    lim = ref.shape[1]
    shown = sorted({0, 1, 2, 5, 10, 20, lim // 2, lim - 1} & set(range(lim)))
    log(f"[k1] {tag}: n: mean|c_n| / max|err_n|  " + "; ".join(
        f"{n}: {typ[n].item():.3e} / {per_n[n].item():.3e}" for n in shown))
    log(f"[k1] {tag}: max|err| {err.max().item():.3e}; allclose needs "
        f"rtol=atol >= {t_need:.3e}; worst max|err_n|/mean|c_n| "
        f"{rel.max().item():.3e} at n={int(rel.argmax())}")
    return err.max().item(), t_need, rel.max().item()


def ar_lags(P, order, gen, device):
    """Lags of AR(2)-coloured noise (the rows of tests/test_pallas_ops.py),
    computed in float64 on the card, returned as float32."""
    n = 300
    s = torch.randn(P, n, generator=gen, dtype=torch.float64).to(device)
    for a in (0.9, -0.5):
        s[:, 1:] += a * s[:, :-1].clone()
    r = torch.stack([(s[:, : n - k] * s[:, k:]).sum(1) for k in range(order + 2)], 1)
    return r.float().contiguous()


def speechlike_batch(rng, B, lo_s, hi_s, srate=16000):
    """B of benchmark/common.py's speech-like utterances with lengths
    uniform in [lo_s, hi_s] seconds, zero-padded. Returns (signals (B, Nmax)
    float32, lengths (B,) int32)."""
    lens = rng.randint(int(lo_s * srate), int(hi_s * srate) + 1, B).astype(np.int32)
    x = np.zeros((B, int(lens.max())), np.float32)
    for b, sig in enumerate(speechlike_signals(rng, lens, srate)):
        x[b, : len(sig)] = sig
    return x, lens


def near_periodic(seed=0, srate=16000, seconds=4):
    """The harmonic-stack input of tests/test_dsp_parity.py (finiteness)."""
    rs = np.random.RandomState(seed)
    t = np.arange(seconds * srate) / srate
    sig = np.zeros_like(t)
    for k in range(1, 12):
        sig += np.sin(2 * np.pi * 220.0 * k * t + rs.uniform(0, 6))
    return (sig / np.abs(sig).max() * 18000 + rs.randn(len(t)) * 10)[None]


def valid_rows(x, n):
    return torch.cat([x[b, : int(n[b])] for b in range(len(n))])


def _uniform(rng, *shape, fan):
    b = 1.0 / np.sqrt(fan)
    return rng.uniform(-b, b, shape).astype(np.float32)


def random_gru_cell(rng, d, H):
    """A flax GRUCell parameter tree (ir/iz/in with biases, hr/hz/hn, hn's bias)."""
    cell = {f"i{g}": {"kernel": _uniform(rng, d, H, fan=d), "bias": _uniform(rng, H, fan=H)}
            for g in "rzn"}
    cell.update({f"h{g}": {"kernel": _uniform(rng, H, H, fan=H)} for g in "rzn"})
    cell["hn"]["bias"] = _uniform(rng, H, fan=H)
    return cell


def random_gru_params(rng, D, layers, H, C):
    """A flax-layout RNNClassifier parameter tree of seeded numpy arrays,
    carried over with io/jax_params.py like real JAX weights."""
    stack = {f"gru_{i}": {"cell": random_gru_cell(rng, D if i == 0 else H, H)}
             for i in range(layers)}
    reg = {"kernel": _uniform(rng, H, C, fan=H), "bias": _uniform(rng, C, fan=H)}
    return {"params": {"GRUStack_0": stack, "regression": reg}}


def random_asr_params(rng, cfg, idim):
    """A flax-layout TransformerASR parameter tree of seeded numpy arrays at
    flax's init scales (kernels N(0, 1/fan_in)), with small random biases
    and LayerNorm affines so that every leaf matters; conformer encoder
    blocks (flax's explicit names) when cfg.encoder_type is 'conformer'."""
    A, H = cfg.adim, cfg.aheads

    def normal(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def small(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o, fan=i), "bias": small(o)}

    def norm():
        return {"scale": 1 + small(A), "bias": small(A)}

    def mha():
        p = {n: {"kernel": normal(A, H, A // H, fan=A), "bias": small(H, A // H)}
             for n in ("query", "key", "value")}
        p["out"] = {"kernel": normal(H, A // H, A, fan=A), "bias": small(A)}
        return p

    def block(ff, cross):
        p = {f"LayerNorm_{i}": norm() for i in range(3 if cross else 2)}
        p.update({f"MultiHeadDotProductAttention_{i}": mha() for i in range(2 if cross else 1)})
        p.update(Dense_0=dense(A, ff), Dense_1=dense(ff, A))
        return p

    def conformer_block(ff):
        k = cfg.conv_kernel
        p = {f"{n}_norm": norm() for n in ("ffn1", "mhsa", "conv", "conv_mid", "ffn2", "final")}
        p.update(ffn1_in=dense(A, ff), ffn1_out=dense(ff, A), ffn2_in=dense(A, ff),
                 ffn2_out=dense(ff, A), mhsa=mha(), conv_pointwise_in=dense(A, 2 * A),
                 conv_pointwise_out=dense(A, A),
                 conv_depthwise={"kernel": normal(k, 1, A, fan=k), "bias": small(A)})
        return p

    enc_block = ((lambda: conformer_block(cfg.eunits)) if cfg.encoder_type == "conformer"
                 else (lambda: block(cfg.eunits, False)))
    d2 = ((idim - 1) // 2 - 1) // 2
    embed = {"Conv_0": {"kernel": normal(3, 3, 1, A, fan=9), "bias": small(A)},
             "Conv_1": {"kernel": normal(3, 3, A, A, fan=9 * A), "bias": small(A)},
             "Dense_0": dense(d2 * A, A)}
    enc = {"embed": embed, "after_norm": norm(),
           **{f"layer_{i}": enc_block() for i in range(cfg.elayers)}}
    dec = {"embed": {"embedding": normal(cfg.vocab_size, A, fan=A)}, "after_norm": norm(),
           "output": dense(A, cfg.vocab_size),
           **{f"layer_{i}": block(cfg.dunits, True) for i in range(cfg.dlayers)}}
    return {"params": {"encoder": enc, "decoder": dec, "ctc_head": dense(A, cfg.vocab_size)}}


def random_rnnlm_params(rng, V, E, H):
    """A flax-layout one-layer GRU RNNLM parameter tree."""
    return {"params": {
        "embed": {"embedding": (rng.standard_normal((V, E)) / np.sqrt(E)).astype(np.float32)},
        "rnn": {"gru_0": {"cell": random_gru_cell(rng, E, H)}},
        "output": {"kernel": _uniform(rng, H, V, fan=H), "bias": _uniform(rng, V, fan=H)},
    }}


def e2e_phase(x, lens, fdlp_cfg, rng, dev):
    """The e2e recognition slice (recipes/configs/wsj_fdlp_e2e.json) on the
    featgen batch: FDLP (K1) -> global CMVN -> TransformerASR (vocab 52,
    adim 256, 4 heads, 12 encoder / 6 decoder layers, FFN 2048) -> beam 10
    joint CTC/attention search (ctc_weight 0.3, penalty 0, max_len 100)
    fused with a 1 x 1000 GRU RNNLM (embed 256) at weight 1.0, seeded
    random flax-layout weights. Returns (K1's launches over the driven run,
    {"asr", "lm", "mem", "enc_len", "ctc", "vocab"}: the model, its RNNLM
    and the encoder output of the first four utterances, for phase 9, and
    the whole batch's under "mem_all", "enc_len_all", "ctc_all", for phase
    11)."""
    import string

    from speech_recognition_tools_tpu_torch.decode.beam_jit import tokens_to_list
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.infer.recognize import recognize_batch
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        rnnlm_from_jax,
        transformer_asr_from_jax,
    )
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab, decode_tokens
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
    )
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn, cmvn_stats_masked

    cfg = TransformerASRConfig(**E2E_AM)
    idim, V, eos = fdlp_cfg.nfilters, cfg.vocab_size, cfg.eos_id
    asr_params = random_asr_params(rng, cfg, idim)
    lm_params = random_rnnlm_params(rng, V, cfg.adim, E2E_LM_HIDDEN)

    def build(device):
        asr = TransformerASR(cfg, idim, device=device)
        asr.load_state_dict(transformer_asr_from_jax(asr_params))
        lm = RNNLM(V, cfg.adim, E2E_LM_HIDDEN, 1, device=device)
        lm.load_state_dict(rnnlm_from_jax(lm_params))
        return asr.eval(), lm.eval()

    asr, lm = build(dev)
    vocab = build_char_vocab([string.ascii_letters[: V - 4]])
    assert len(vocab) == V
    B = len(lens)
    audio_s = float(lens.sum()) / fdlp_cfg.srate
    feats, nfr = fdlp_spectrogram_batch(x, lens, fdlp_cfg, device=dev)
    mean, std = cmvn_stats_masked(feats, nfr)

    def front(c):
        f, n = fdlp_spectrogram_batch(x, lens, c, device=dev)
        return apply_cmvn(f, mean, std), n

    def encode(f, n, model=asr):
        with torch.no_grad():
            return model.encode(f, n)

    def search(mem, enc_len, ctc, model=asr, fused=lm, max_len=E2E_MAX_LEN):
        with torch.no_grad():
            return beam_search_encoded(model, mem, enc_len, ctc, lm=fused, max_len=max_len,
                                       **E2E_BEAM)

    # the main path, counted, through the entry point a user calls
    lpc_cepstra.launches = 0
    K2.reset()
    GRAPHS.reset()
    texts = recognize_batch(x, lens, fdlp_cfg, mean, std, asr, vocab, lm=lm, **E2E_BEAM,
                            max_len=E2E_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    launches = lpc_cepstra.launches
    assert launches > 0, "the e2e path did not launch K1"
    k2_e2e = K2.read("e2e")
    GRAPHS.read("e2e")

    # the same chain part by part, held to the one call
    feats, nfr = front(fdlp_cfg)
    mem, enc_len, ctc = encode(feats, nfr)
    K2.reset()
    GRAPHS.reset()
    toks, scores = search(mem, enc_len, ctc)
    steps = search_steps(toks)
    K2.read("e2e_search", steps)
    GRAPHS.read("e2e_search")
    hyps = [tokens_to_list(toks[b], scores[b], eos) for b in range(B)]
    assert texts == [decode_tokens(h, vocab) for h in hyps], "recognize_batch != its parts"
    assert all(isinstance(t, str) for t in texts) and len(texts) == B
    assert toks.shape == (B, E2E_BEAM["beam_size"], E2E_MAX_LEN + 1)
    assert torch.isfinite(scores).all(), scores
    assert mem.shape == (B, ctc.shape[1], cfg.adim) and ctc.shape[2] == V
    assert torch.isfinite(valid_rows(mem, enc_len)).all()
    assert torch.isfinite(valid_rows(ctc, enc_len)).all()

    # CTC log-probs from K1 features against those from the plain backend's
    f_s, n_s = front(FdlpConfig(**{**fdlp_cfg.__dict__, "lpc_backend": "scan"}))
    assert torch.equal(nfr, n_s)
    _, _, ctc_s = encode(f_s, n_s)
    ctc_err = (valid_rows(torch.log_softmax(ctc, -1), enc_len)
               - valid_rows(torch.log_softmax(ctc_s, -1), enc_len)).abs().max().item()
    assert ctc_err <= E2E_CTC_TOL, ctc_err

    # the encoder on the card against the CPU, two utterances
    cpu_asr, cpu_lm = build("cpu")
    two = nfr[:2].cpu()
    f2 = feats[:2, : int(two.max())]
    m_c, l_c, c_c = encode(f2.cpu(), two, model=cpu_asr)
    m_g, l_g, c_g = encode(f2, nfr[:2])
    assert torch.equal(l_g.cpu(), l_c)
    enc_err = max((valid_rows(g.cpu(), l_c) - valid_rows(c, l_c)).abs().max().item()
                  for g, c in ((m_g, m_c), (c_g, c_c)))
    assert enc_err < 1e-4, enc_err

    # the search on the card against the CPU from the same memory
    t_g, s_g = search(mem[:2], enc_len[:2], ctc[:2], max_len=E2E_CPU_MAX_LEN)
    t_c, s_c = search(mem[:2].cpu(), enc_len[:2].cpu(), ctc[:2].cpu(), model=cpu_asr,
                      fused=cpu_lm, max_len=E2E_CPU_MAX_LEN)
    best_g, best_c = s_g.max(1).values.cpu(), s_c.max(1).values
    beam_rel = ((best_g - best_c).abs() / best_c.abs()).max().item()
    same = sum(tokens_to_list(t_g[b], s_g[b], eos) == tokens_to_list(t_c[b], s_c[b], eos)
               for b in range(2))
    assert beam_rel <= 1e-4, (best_g, best_c)

    log(f"[e2e] wsj_fdlp_e2e {B} x {lens.min() / 16000:.1f}-{lens.max() / 16000:.1f} s "
        f"({audio_s:.1f} s audio), {int(enc_len.max())} encoder frames max, vocab {V}, "
        f"{cfg.elayers}/{cfg.dlayers} layers, beam {E2E_BEAM['beam_size']}, RNNLM 1 x "
        f"{E2E_LM_HIDDEN}: K1 launches {launches}, K2 launches {k2_e2e}; {steps} beam steps "
        f"of max_len {E2E_MAX_LEN}, K2 once a step")
    log(f"[e2e] max|CTC logp(K1) - CTC logp(plain)| {ctc_err:.3e} (limit {E2E_CTC_TOL}); "
        f"encoder cuda vs cpu max|err| {enc_err:.3e} (atol 1e-4); beam cuda vs cpu at max_len "
        f"{E2E_CPU_MAX_LEN} best score rel err {beam_rel:.3e} (limit 1e-4), token-identical "
        f"{same} of 2")
    log(f"[e2e] sample hypotheses: {texts[0][:60]!r} / {texts[1][:60]!r}")
    return launches, dict(asr=asr, lm=lm, mem=mem[:4], enc_len=enc_len[:4], ctc=ctc[:4],
                          vocab=vocab, mem_all=mem, enc_len_all=enc_len, ctc_all=ctc)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _synced(fn):
    """(seconds, result) of fn() with the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _worst_grad(got, ref):
    """The parameter whose gradient differs most (by norm): (its name, the
    difference's norm over the global gradient norm, over its own)."""
    diff = {k: (got[k] - ref[k]).norm().item() for k in ref}
    total = sum(v.norm().item() ** 2 for v in ref.values()) ** 0.5
    k = max(diff, key=diff.get)
    return k, diff[k] / total, diff[k] / max(ref[k].norm().item(), 1e-30)


def _median_parts(rows):
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def hybrid_train_phase(xh, lh, rng, dev, tmp):
    """Hybrid training at timit_hybrid (recipes/configs/timit_hybrid.json):
    FDLP (K1) -> global CMVN -> egs with seeded frame labels ->
    train_am.main --arch rnn at full width. Returns K1's launches over the
    path (featgen through training); K3's over train_am.main go under
    K3.by_path["hybrid_train"], the main path's count."""
    import os

    from speech_recognition_tools_tpu_torch.cli import train_am
    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.jax_params import rnn_classifier_from_jax
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer, host_copy
    from speech_recognition_tools_tpu_torch.utils.cmvn import cmvn_stats_masked

    hyb = FdlpConfig()
    H = HYBRID_TRAIN
    egs, dev_egs, store = (os.path.join(tmp, d) for d in ("hyb_egs", "hyb_dev", "hyb_am"))
    lpc_cepstra.launches = 0
    t_path = time.perf_counter()
    feats, nfr = fdlp_spectrogram_batch(xh, lh, hyb, device=dev)
    mean, std = (t.cpu().numpy() for t in cmvn_stats_masked(feats, nfr))
    utts = [(f"utt{b:02d}", feats[b, : int(nfr[b])].cpu().numpy()) for b in range(len(lh))]
    labels = {k: rng.randint(0, HYBRID_CLASSES, f.shape[0]) for k, f in utts}
    # every class at least once, as in a real alignment, so that phase 9's
    # log-prior (compute_prior on these egs) is finite
    flat = np.concatenate(list(labels.values()))
    assert flat.size >= HYBRID_CLASSES
    flat[:HYBRID_CLASSES] = np.arange(HYBRID_CLASSES)
    labels = dict(zip(labels, np.split(flat, np.cumsum([len(v) for v in labels.values()])[:-1])))
    build_egs(iter(utts), egs, labels, cmvn=(mean, std), num_targets=HYBRID_CLASSES)
    build_egs(iter(utts[: H["batch_size"]]), dev_egs, labels, cmvn=(mean, std),
              num_targets=HYBRID_CLASSES)
    argv = [egs, store, "--arch", "rnn", "--dev_egs_dir", dev_egs, "--device", str(dev)]
    argv += [a for k, v in H.items() for a in (f"--{k}", str(v))]
    K3.reset()
    st = train_am.main(argv)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_path
    # K3 on the main path: each epoch's train steps forward and backward,
    # its dev batches forward, once a layer each
    train_batches, dev_batches = (sum(1 for _ in iter_egs_batches(d, H["batch_size"]))
                                  for d in (egs, dev_egs))
    k3_main = K3.read("hybrid_train",
                      H["epochs"] * H["num_layers"] * (2 * train_batches + dev_batches))
    launches = lpc_cepstra.launches
    assert launches > 0, "the hybrid training path did not launch K1"
    assert len(st.history) == H["epochs"], st.history
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["dev_loss"])
               for h in st.history), st.history
    assert sorted(os.listdir(store)) == ["epoch_1", "epoch_2", "final"], os.listdir(store)
    payload, meta = load_checkpoint(os.path.join(store, "final"))
    back = RNNClassifier(hyb.nfilters, H["num_layers"], H["hidden_dim"], HYBRID_CLASSES,
                         device=dev)
    back.load_state_dict(rnn_classifier_from_jax(payload["params"]))
    assert all(torch.equal(p.cpu(), st.best_params[k]) for k, p in back.named_parameters())
    assert meta["model_class"] == "RNNClassifier" and meta["num_classes"] == HYBRID_CLASSES

    args = train_am.get_parser().parse_args(argv)
    loss_fn = train_am.make_loss(args)
    cfg = TrainConfig(learning_rate=H["learning_rate"], clip_threshold=H["clip_thresh"])

    def fresh(device):
        m = RNNClassifier(hyb.nfilters, H["num_layers"], H["hidden_dim"], HYBRID_CLASSES,
                          device=device)
        m.reset_parameters(torch.Generator().manual_seed(7))
        tr = Trainer(m, loss_fn, cfg)
        return tr, tr.init_state()

    def to(batch, device):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items() if k != "keys"}

    # one step, card against CPU: identical weights, the 4 shortest utterances
    small = next(iter_egs_batches(egs, 4))
    steps = {}
    for device in ("cpu", dev):
        tr, st1 = fresh(device)
        before = host_copy(st1.params)
        loss, _, gnorm = tr.train_step(st1, to(small, device))
        grads = {k: p.grad.detach().cpu() for k, p in st1.params.items()}
        delta = {k: p.detach().cpu() - before[k] for k, p in st1.params.items()}
        steps[str(device)] = (loss.item(), gnorm, grads, delta)
    (l_c, g_c, gr_c, d_c), (l_g, g_g, gr_g, d_g) = steps["cpu"], steps[str(dev)]
    # the update the optimizer makes on the card against the one it makes on
    # the CPU from the same (the card's) gradients
    same = {k: v.clone() for k, v in before.items()}
    opt_c = tr.opt
    opt_c.apply(same, gr_g, opt_c.init(same))
    upd_err = max(((d_g[k] - (same[k] - before[k])).abs().max().item() for k in d_c))
    # end to end, Adam's first update lr * g / (|g| + eps) turns gradient
    # rounding on entries with |g| near eps into differences up to lr
    e2e_err = max((d_g[k] - d_c[k]).abs().max().item() for k in d_c)
    off = [gr_c[k][(d_g[k] - d_c[k]).abs() > 1e-3 * H["learning_rate"]] for k in d_c]
    off = torch.cat([o.flatten() for o in off])
    off_g = off.abs().max().item() if off.numel() else 0.0
    g_worst = _worst_grad(gr_g, gr_c)
    assert _rel(l_g, l_c) <= 1e-5, (l_g, l_c)
    assert _rel(g_g, g_c) <= 1e-4, (g_g, g_c)
    assert upd_err <= 1e-3 * H["learning_rate"], upd_err

    log(f"[hybrid-train] timit_hybrid: train_am.main --arch rnn {H['num_layers']} x "
        f"{H['hidden_dim']} GRU, {HYBRID_CLASSES} "
        f"classes, {H['epochs']} epochs x 2 batches of {H['batch_size']} + a dev batch: "
        f"{t_path:.2f} s for FDLP -> egs -> train_am.main, K1 launches {launches}, K3 launches "
        f"{k3_main} ({train_batches} train steps and {dev_batches} dev batch(es) an epoch); "
        f"losses " + ", ".join(f"train {h['train_loss']:.4f} dev {h['dev_loss']:.4f}"
                               for h in st.history))
    log(f"[hybrid-train] card vs cpu, one step on 4 utterances: loss {l_g:.6f} / {l_c:.6f} "
        f"(rel {_rel(l_g, l_c):.3e}, limit 1e-5), grad norm {g_g:.6f} / {g_c:.6f} "
        f"(rel {_rel(g_g, g_c):.3e}, limit 1e-4); Adam update from the card's gradients, card "
        f"vs cpu: max|diff| {upd_err:.3e} (limit {1e-3 * H['learning_rate']:.1e}); end to end "
        f"max|update diff| {e2e_err:.3e}, {off.numel()} entries above the limit, their "
        f"largest |gradient| {off_g:.3e}; the gradient that differs most: {g_worst[0]}, "
        f"|diff| {g_worst[1]:.3e} of the global norm, {g_worst[2]:.3e} of its own")
    return launches


def e2e_train_phase(x, lens, fdlp_cfg, rng, dev, tmp):
    """e2e training at wsj_fdlp_e2e: FDLP (K1) -> global CMVN -> egs +
    seeded transcripts -> train_e2e.main at full width; its final_avg
    checkpoint decodes through recognize_batch. Returns K1's launches over
    the training path (featgen through training)."""
    import os
    import string

    from speech_recognition_tools_tpu_torch.cli import train_e2e
    from speech_recognition_tools_tpu_torch.dsp.fdlp import fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.infer.recognize import recognize_batch
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab, read_text_file
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
        asr_loss,
        ctc_loss,
        decoder_inputs,
        joint_loss,
        noam_schedule,
        subsampled_length,
    )
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam
    from speech_recognition_tools_tpu_torch.utils.cmvn import cmvn_stats_masked

    E = E2E_TRAIN
    V = E2E_AM["vocab_size"]
    letters = string.ascii_letters[: V - 4]
    vocab = build_char_vocab([letters])
    assert len(vocab) == V
    egs, store, text = (os.path.join(tmp, d) for d in ("e2e_egs", "e2e_am", "e2e_text"))

    lpc_cepstra.launches = 0
    t_path = time.perf_counter()
    feats, nfr = fdlp_spectrogram_batch(x, lens, fdlp_cfg, device=dev)
    mean, std = (t.cpu().numpy() for t in cmvn_stats_masked(feats, nfr))
    utts, texts = [], {}
    for b in range(len(lens)):
        f = feats[b, : int(nfr[b])].cpu().numpy()
        enc_len = ((f.shape[0] - 1) // 2 - 1) // 2
        top = (enc_len - 1) // 2  # CTC can align it even if every letter repeats
        for copy in "ab":
            key = f"utt{b:02d}{copy}"
            utts.append((key, f))
            texts[key] = random_transcript(rng, letters, rng.randint(top // 2, top + 1))
    with open(text, "w") as fh:
        fh.writelines(f"{k} {v}\n" for k, v in texts.items())
    build_egs(iter(utts), egs, cmvn=(mean, std))
    argv = [egs, text, store, "--device", str(dev)]
    argv += [a for k, v in {**E2E_AM, **E}.items() if k != "vocab_size"
             for a in (f"--{k}", str(v))]
    losses = train_e2e.main(argv)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_path
    launches = lpc_cepstra.launches
    assert launches > 0, "the e2e training path did not launch K1"
    assert len(losses) == E["epochs"] and all(np.isfinite(losses)), losses
    assert sorted(os.listdir(store)) == ["epoch_1", "epoch_2", "final_avg", "vocab.json"]
    assert read_text_file(text) == texts

    cfg = TransformerASRConfig(**E2E_AM, dropout=E["dropout"], mtlalpha=E["mtlalpha"],
                               lsm_weight=E["lsm_weight"])
    payload, meta = load_checkpoint(os.path.join(store, "final_avg"))
    assert meta["extra"] == {"averaged": 2} and meta["vocab_size"] == V
    asr = TransformerASR(cfg, fdlp_cfg.nfilters, device=dev)
    asr.load_state_dict(transformer_asr_from_jax(payload["params"]))
    asr.eval()
    t_rec, hyps = _synced(lambda: recognize_batch(
        x[:2], lens[:2], fdlp_cfg, mean, std, asr, vocab, beam_size=E2E_BEAM["beam_size"],
        ctc_weight=E2E_BEAM["ctc_weight"], max_len=E2E_TRAIN_DECODE_LEN, device=dev))
    assert len(hyps) == 2 and all(isinstance(h, str) for h in hyps), hyps

    batches = list(train_e2e.token_batches(egs, texts, vocab, E["batch_size"]))
    assert len(batches) == 2 and all(len(b["lengths"]) == E["batch_size"] for b in batches)
    full = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}

    # one step at dropout 0, card against CPU, on two utterances
    cfg0 = TransformerASRConfig(**E2E_AM, dropout=0.0, mtlalpha=E["mtlalpha"],
                                lsm_weight=E["lsm_weight"])
    two = {k: torch.as_tensor(v[:2]) for k, v in batches[0].items()}
    two["feats"] = two["feats"][:, : int(two["lengths"].max())]
    got = {}
    for device in ("cpu", dev):
        m = TransformerASR(cfg0, fdlp_cfg.nfilters, device=device)
        m.reset_parameters(torch.Generator().manual_seed(11))
        loss, aux = asr_loss(m, {k: v.to(device) for k, v in two.items()}, cfg0)
        loss.backward()
        gnorm = ClipAdam.global_norm([p.grad for p in m.parameters()]).item()
        got[str(device)] = (loss.item(), aux["ctc"].item(), aux["att"].item(), gnorm,
                            {k: p.grad.cpu() for k, p in m.named_parameters()})
    c, g = got["cpu"], got[str(dev)]
    g_worst = _worst_grad(g[4], c[4])
    for name, a, b in zip(("loss", "ctc", "att"), g, c):
        assert _rel(a, b) <= 1e-5, (name, a, b)
    assert _rel(g[3], c[3]) <= 1e-4, (g[3], c[3])

    # the training model at dropout 0.1 on a batch of 32: parts, memory, profile
    model = TransformerASR(cfg, fdlp_cfg.nfilters, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    opt = ClipAdam(noam_schedule(cfg.adim, E["warmup_steps"], E["transformer_lr"]),
                   E["grad_clip"], b2=0.98)
    opt_state = opt.init(params)
    step = train_e2e.make_train_step(model, cfg, opt)
    opt_state, _, _ = step(opt_state, full)
    rows = []
    torch.cuda.reset_peak_memory_stats()
    tokens_in = decoder_inputs(full["tokens"], full["token_lengths"], cfg.sos_id)
    for _ in range(3):
        for p in params.values():
            p.grad = None
        model.train()
        t_e, (mem, enc_len) = _synced(lambda: model.encoder(full["feats"], full["lengths"]))
        t_d, (ctc_logits, dec_logits) = _synced(
            lambda: (model.ctc_head(mem), model.decoder(tokens_in, mem, enc_len)))
        t_l, (loss, aux) = _synced(lambda: joint_loss(ctc_logits, dec_logits, enc_len, full, cfg))
        t_b, _ = _synced(loss.backward)
        grads = {k: p.grad for k, p in params.items()}
        t_o, (opt_state, _) = _synced(lambda: opt.apply(params, grads, opt_state))
        rows.append({"encoder": t_e, "decoder + ctc head": t_d, "joint loss": t_l,
                     "backward": t_b, "optimizer": t_o})
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts = _median_parts(rows)

    # the CTC loss alone: the port's recursion against F.ctc_loss, feasible rows
    with torch.no_grad():
        logits = model.ctc_head(model.encoder(full["feats"], full["lengths"])[0])
    enc_len = subsampled_length(full["lengths"])
    tl = full["token_lengths"]
    pos = torch.arange(full["tokens"].shape[1], device=dev)[None, :]
    enc_pad = (torch.arange(logits.shape[1], device=dev)[None, :] >= enc_len[:, None]).float()
    tok_pad = (pos >= tl[:, None]).float()
    port_ctc = ctc_loss(logits, enc_pad, full["tokens"], tok_pad)
    lib_args = (torch.log_softmax(logits, -1).transpose(0, 1), full["tokens"].long(),
                enc_len.long(), tl.long())
    lib_ctc = torch.nn.functional.ctc_loss(*lib_args, reduction="none")
    assert torch.isfinite(lib_ctc).all(), "a row F.ctc_loss cannot align"
    ctc_err = ((port_ctc - lib_ctc) / tl).abs().max().item()
    assert ctc_err <= 1e-4, ctc_err
    ctc_ms = cuda_ms(lambda: ctc_loss(logits, enc_pad, full["tokens"], tok_pad), reps=1, repeats=3)
    lib_ms = cuda_ms(lambda: torch.nn.functional.ctc_loss(*lib_args, reduction="none"),
                     reps=1, repeats=3)
    lg = logits.detach().requires_grad_()
    ctc_fb_ms = cuda_ms(lambda: ctc_loss(lg, enc_pad, full["tokens"], tok_pad).sum().backward(),
                        reps=1, repeats=3)
    lib_fb_ms = cuda_ms(lambda: torch.nn.functional.ctc_loss(
        torch.log_softmax(lg, -1).transpose(0, 1), *lib_args[1:], reduction="none")
        .sum().backward(), reps=1, repeats=3)

    t_step, _ = wall_s(lambda: step(opt_state, full))
    device_breakdown(f"e2e train step (B={len(full['lengths'])})", lambda: step(opt_state, full))
    audio_s = float(full["lengths"].sum()) / fdlp_cfg.frate
    log(f"[e2e-train] wsj_fdlp_e2e: train_e2e.main {cfg.elayers}/{cfg.dlayers} layers adim "
        f"{cfg.adim}, vocab {V}, "
        f"{E['epochs']} epochs x 2 batches of {E['batch_size']}: {t_path:.2f} s for FDLP -> "
        f"egs -> train_e2e.main, K1 launches {launches}; epoch losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    log(f"[e2e-train] final_avg -> recognize_batch, 2 utterances, max_len "
        f"{E2E_TRAIN_DECODE_LEN}: {t_rec:.2f} s; hypotheses {hyps[0][:40]!r} / {hyps[1][:40]!r}")
    log(f"[e2e-train] card vs cpu, one step at dropout 0 on 2 utterances: loss "
        f"{g[0]:.6f} / {c[0]:.6f} (rel {_rel(g[0], c[0]):.3e}), ctc rel "
        f"{_rel(g[1], c[1]):.3e}, att rel {_rel(g[2], c[2]):.3e} (limit 1e-5); grad norm "
        f"{g[3]:.6f} / {c[3]:.6f} (rel {_rel(g[3], c[3]):.3e}, limit 1e-4); the gradient "
        f"that differs most: {g_worst[0]}, |diff| {g_worst[1]:.3e} of the global norm, "
        f"{g_worst[2]:.3e} of its own")
    log(f"[e2e-train] CTC loss on the card, B={len(full['lengths'])}, {int(logits.shape[1])} "
        f"frames, "
        f"{int(full['tokens'].shape[1])} label slots: port {ctc_ms:.2f} ms forward / "
        f"{ctc_fb_ms:.2f} ms forward+backward; F.ctc_loss (library) {lib_ms:.3f} / "
        f"{lib_fb_ms:.3f} ms; max|port - library| per token {ctc_err:.3e} (atol 1e-4)")
    log(f"[e2e-train] B={len(full['lengths'])} ({audio_s:.1f} s audio, {int(full['feats'].shape[1])} frames "
        f"padded, {int(logits.shape[1])} encoder frames): {t_step * 1e3:.1f} ms a step = "
        f"{audio_s / t_step:.1f} audio s per s; synchronised parts: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in parts.items())
        + f"; peak memory {peak:.2f} GiB")
    return launches


def _ctc_near_ties(rows):
    """Frames of (T, V) CTC logits whose top two are within SERVE_NEAR_TIE."""
    top2 = np.sort(np.asarray(rows), axis=-1)[:, -2:]
    return int((top2[:, 1] - top2[:, 0] < SERVE_NEAR_TIE).sum())


def _serve_client(port, sig, step, endpoint_blanks=0):
    """One socket stream of `sig` in messages of `step` samples, unpaced:
    per-message send-to-reply seconds, the endpoints' tokens, the final
    and its latency after eof."""
    s = socket.create_connection(("127.0.0.1", port), timeout=600)
    f = s.makefile("rwb")

    def ask(obj):
        t0 = time.perf_counter()
        f.write((json.dumps(obj) + "\n").encode())
        f.flush()
        msg = json.loads(f.readline())
        assert "error" not in msg, msg
        return msg, time.perf_counter() - t0

    try:
        if endpoint_blanks:
            assert ask({"config": {"endpoint_blanks": endpoint_blanks}})[0] == {"ok": True}
        lat, endpoints = [], []
        for off in range(0, len(sig), step):
            msg, dt = ask({"pcm": sig[off : off + step].tolist()})
            lat.append(dt)
            if "endpoint" in msg:
                endpoints.append(msg["endpoint"]["tokens"])
        final, t_final = ask({"eof": True})
    finally:
        s.close()
    return dict(lat=lat, endpoints=endpoints, final=final, t_final=t_final,
                t_end=time.perf_counter())


def _pipeline_run(pipe, sig, step):
    """(final tokens, CTC rows) of OnlineASRPipeline on `sig` pushed in
    messages of `step` samples."""
    pipe.reset()
    for off in range(0, len(sig), step):
        pipe.push(sig[off : off + step])
    return pipe.finish(), pipe.recognizer.ctc_logits


def serve_phase(x, lens, fdlp_cfg, feats, nfr, rng, dev, tmp):
    """Online serving at wsj_fdlp_e2e width with the recipes' streaming
    setting (attn_chunk 16, 4 left chunks): srt-serve's make_server on a
    model directory with serving.json and global CMVN, 8 concurrent socket
    streams of phase 3's utterances and one endpointing stream; then
    cli.transcribe and cli.recog_e2e on the same directory. `feats`, `nfr`
    are phase 3's batch features (K1). Returns K1's launches over the
    served streams and over the transcribe CLI."""
    import string

    t_phase = time.perf_counter()
    from scipy.io.wavfile import write as wav_write

    from speech_recognition_tools_tpu_torch.cli import recog_e2e, serve, transcribe
    from speech_recognition_tools_tpu_torch.dsp.fdlp import window_lags
    from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import (
        OnlineASRPipeline,
        StreamBatcher,
        StreamingRecognizer,
        _posenc_rows,
    )
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab, save_vocab
    from speech_recognition_tools_tpu_torch.models.transformer_asr import TransformerASRConfig
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint
    from speech_recognition_tools_tpu_torch.utils.cmvn import cmvn_stats_masked

    # ---- the model directory, as train_e2e and run_corpus write it ----
    cfg = TransformerASRConfig(**E2E_AM, **SERVE_CHUNK)
    V, idim = cfg.vocab_size, fdlp_cfg.nfilters
    params = random_asr_params(rng, cfg, idim)
    params["params"]["ctc_head"]["bias"][cfg.blank_id] += SERVE_BLANK_BIAS
    model_dir, lm_dir = os.path.join(tmp, "serve_am"), os.path.join(tmp, "serve_lm")
    hyper = dict(model_class="TransformerASR", **E2E_AM, **SERVE_CHUNK, mtlalpha=0.3,
                 lsm_weight=0.1, encoder_type="transformer", feature_dim=idim)
    save_checkpoint(model_dir, "final_avg", params, hyper)
    vocab = build_char_vocab([string.ascii_letters[: V - 4]])
    assert len(vocab) == V
    save_vocab(vocab, os.path.join(model_dir, "vocab.json"))
    mean, std = (t.cpu().numpy() for t in cmvn_stats_masked(feats, nfr))
    np.savez(os.path.join(model_dir, "cmvn.npz"), mean=mean, std=std)
    frontend = {k: getattr(fdlp_cfg, k) for k in ("srate", "nfilters", "coeff_num",
                                                  "coeff_range", "order", "fduration")}
    with open(os.path.join(model_dir, "serving.json"), "w") as fh:
        json.dump({"frontend": {"type": "fdlp", **frontend}, "cmvn": "cmvn.npz",
                   "cmvn_mode": "global"}, fh)
    save_checkpoint(lm_dir, "final", random_rnnlm_params(rng, V, cfg.adim, E2E_LM_HIDDEN),
                    dict(vocab_size=V, embed_dim=cfg.adim, hidden=E2E_LM_HIDDEN, layers=1,
                         cell="gru"))

    S = SERVE_STREAMS
    step = int(SERVE_PUSH_S * fdlp_cfg.srate)
    sigs = [x[b, : int(lens[b])] for b in range(S + 2)]
    ep_sig = np.concatenate(sigs[S:])  # the endpointing stream: two utterances
    pipe = OnlineASRPipeline.from_model_dir(model_dir, device=dev)
    assert pipe.fdlp_cfg == fdlp_cfg and np.array_equal(pipe.cmvn_mean, mean)
    # the endpointing stream's threshold: the largest that splits its audio
    # into >= 2 utterances on the pipeline
    R, want_segments = None, None
    for cand in (8, 6, 4, 3, 2, 1):
        ep = OnlineASRPipeline.from_model_dir(model_dir, device=dev, endpoint_blanks=cand)
        _pipeline_run(ep, ep_sig, step)
        if len(ep.segments) >= 2:
            R, want_segments = cand, ep.segments
            break
    assert R is not None, "no endpoint threshold splits the endpointing stream"

    # ---- the main path: 8 concurrent streams and one endpointing stream ----
    server, port = serve.make_server(model_dir, max_streams=S, defer_s=SERVE_DEFER_S,
                                     device=dev)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        results = [None] * S

        def run(i):
            results[i] = _serve_client(port, sigs[i], step)

        lpc_cepstra.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(S)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        t_served = max(r["t_end"] for r in results) - t0
        ep_run = _serve_client(port, ep_sig, step, endpoint_blanks=R)
        torch.cuda.synchronize()
        serve_launches = lpc_cepstra.launches
        rounds = server.service.batcher.rounds
    finally:
        server.shutdown()
        server.server_close()
    assert serve_launches > 0, "the serving path did not launch K1"
    assert ep_run["endpoints"], "no endpoint fired mid-stream"
    got_segments = ep_run["endpoints"] + ([ep_run["final"]["tokens"]]
                                          if ep_run["final"]["tokens"] else [])
    assert got_segments == want_segments, (got_segments, want_segments)

    # each final against the pipeline on the same audio and messages
    mismatched = near_frames = 0
    for sig, res in zip(sigs[:S], results):
        want, rows = _pipeline_run(pipe, sig, step)
        fin = res["final"]
        assert fin["frames"] == rows.shape[0] and np.isfinite(rows).all()
        assert len(fin["times"]) == len(fin["tokens"]) == len(fin["confs"])
        if fin["tokens"] != want:
            mismatched += 1
            near_frames += _ctc_near_ties(rows)
            assert _ctc_near_ties(rows) > 0, (fin["tokens"], want)

    # streamed features (StreamingFdlp, K1) against the batch path's
    feat_err, feat_need, stream_feats, push_ms = 0.0, 0.0, [], []
    for b, sig in enumerate(sigs[:S]):
        sf = StreamingFdlp(fdlp_cfg, device=dev)
        outs = []
        for off in range(0, len(sig), step):
            t1 = time.perf_counter()
            outs.append(sf.process(sig[off : off + step]))
            push_ms.append(1e3 * (time.perf_counter() - t1))
        outs.append(sf.finish())
        got = np.concatenate(outs)
        ref = feats[b, : int(nfr[b])].cpu().numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        feat_err = max(feat_err, float(np.abs(got - ref).max()))
        feat_need = max(feat_need, float((np.abs(got - ref) / (1 + np.abs(ref))).max()))
        assert np.allclose(got, ref, **SERVE_FEAT_TOL), (b, feat_err)
        stream_feats.append((got - mean) / std)

    # the streamed encoder memory against the offline chunked encode
    model, _, _ = recog_e2e._load(model_dir, "final_avg", device=dev)
    mem_err = 0.0
    for f in stream_feats[:2]:
        sr = StreamingRecognizer(model)
        for off in range(0, f.shape[0], 25):
            sr.push(f[off : off + 25])
        sr.finish()
        with torch.no_grad():
            m, n, _ = model.encode(torch.as_tensor(f[None], device=dev),
                                   torch.tensor([f.shape[0]], device=dev))
        assert sr.enc_len == int(n[0])
        mem_err = max(mem_err, float(np.abs(sr.memory - m[0, : sr.enc_len].cpu().numpy()).max()))
    assert mem_err <= SERVE_MEM_ATOL, mem_err

    # K1 on the streamer's own lags: one window (a 0.25 s push readies at
    # most one) and a block of 8 (a long push)
    sf = StreamingFdlp(fdlp_cfg, device=dev)
    sf.process(sigs[0])
    k1 = []
    for F in (1, 8):
        r = window_lags(sf.block_windows(range(F)), fdlp_cfg, device=dev)
        r = r.reshape(-1, r.shape[-1])
        P, order, lim = r.shape[0], fdlp_cfg.order, fdlp_cfg.coeff_num
        got = lpc_cepstra(r, order, lim)
        ref = lpc_cepstra_reference(r, order, lim)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        err, t_need, rel = cep_agreement(f"serving lags P={P}", got, ref)
        assert t_need <= MAIN_PATH_TOL and rel <= MAIN_PATH_REL, (t_need, rel)
        ms = graph_ms(lambda: lpc_cepstra(r, order, lim))
        plain = cuda_ms(lambda: lpc_cepstra_reference(r, order, lim), reps=2, repeats=3)
        bound, by = bound_ms(*k1_work(P, order, lim))
        k1.append(dict(P=P, err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by))
        log(f"[serve-k1] P={P} order={order} lim={lim}: max|kernel - plain|={err:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain:.3f} bound_ms={bound:.5f} ({by}) "
            f"share_of_bound={bound / ms:.4f}")

    # the transcribe CLI on two wavs against the pipeline
    wavs = []
    for b in range(2):
        wavs.append(os.path.join(tmp, f"serve_utt{b}.wav"))
        wav_write(wavs[-1], fdlp_cfg.srate, sigs[b])
    out = os.path.join(tmp, "serve_transcribe.txt")
    lpc_cepstra.launches = 0
    transcribe.main([model_dir, *wavs, "--out", out, "--device", str(dev)])
    transcribe_launches = lpc_cepstra.launches
    assert transcribe_launches > 0, "the transcribe CLI did not launch K1"
    with open(out) as fh:
        lines = fh.read().splitlines()
    for b, line in enumerate(lines):
        want, rows = _pipeline_run(pipe, sigs[b], len(sigs[b]))
        text = pipe.recognizer.text(want).strip()
        assert line == f"serve_utt{b} {text}".rstrip() or _ctc_near_ties(rows) > 0, (line, text)
    assert len(lines) == 2

    # recog_e2e: --jit_decode against --streaming (beam), RNNLM fused
    egs = os.path.join(tmp, "serve_egs")
    build_egs(((f"utt{b}", feats[b, : int(nfr[b])].cpu().numpy())
               for b in range(SERVE_RECOG_UTTS)), egs, cmvn=(mean, std))
    common = ["--lm_dir", lm_dir, "--max_len", str(SERVE_RECOG_MAX_LEN), "--device", str(dev)]
    K2.reset()
    GRAPHS.reset()
    t_jit, hyp_jit = _synced(lambda: recog_e2e.main(
        [model_dir, egs, os.path.join(tmp, "hyp_jit"), "--jit_decode", "--batch_size",
         str(SERVE_RECOG_UTTS), *common]))
    K2.read("recog_e2e_jit")
    GRAPHS.read("recog_e2e_jit")
    K2.reset()
    GRAPHS.reset()
    t_str, hyp_str = _synced(lambda: recog_e2e.main(
        [model_dir, egs, os.path.join(tmp, "hyp_stream"), "--streaming", "--streaming_final",
         "beam", *common]))
    K2.read("stream_final_beam")  # one B = 1 search an utterance
    GRAPHS.read("stream_final_beam")
    assert sorted(hyp_jit) == sorted(hyp_str) and len(hyp_jit) == SERVE_RECOG_UTTS
    lm = recog_e2e._load_lm(lm_dir, device=dev)
    recog_gaps = []
    for key in sorted(hyp_jit):
        if hyp_jit[key] == hyp_str[key]:
            continue
        b = int(key[3:])
        f = torch.as_tensor((feats[b, : int(nfr[b])].cpu().numpy() - mean) / std, device=dev)
        with torch.no_grad():
            m, n, c = model.encode(f[None], torch.tensor([f.shape[0]], device=dev))
        sr = StreamingRecognizer(model)
        sr.push(f.cpu().numpy())
        sr.finish()
        kw = dict(lm=lm, max_len=SERVE_RECOG_MAX_LEN, **E2E_BEAM)
        _, s_off = beam_search_encoded(model, m, n, c, **kw)
        _, s_str = beam_search_encoded(
            model, torch.as_tensor(sr.memory[None], device=dev), n,
            torch.as_tensor(sr.ctc_logits[None], device=dev), **kw)
        a, z = s_off.max().item(), s_str.max().item()
        recog_gaps.append(abs(a - z) / abs(a))
    assert all(g < 1e-4 for g in recog_gaps), recog_gaps

    # timing: the batched step at 8 full rows, featgen pushes, a profile
    sb = StreamBatcher(model, max_streams=S)
    chunk = cfg.attn_chunk
    xs = torch.as_tensor(rng.standard_normal((S, 4 * chunk + 3, idim)).astype(np.float32),
                         device=dev)
    pe = torch.as_tensor(np.stack([_posenc_rows(64, chunk, cfg.adim)] * S), device=dev)
    nv = torch.full((S,), chunk, device=dev)
    up = torch.ones((S,), dtype=torch.bool, device=dev)

    def round_():
        _, ctc, sb.caches = sb.step(xs, pe, nv, up, sb.caches)
        return ctc.cpu()

    t_round, _ = wall_s(lambda: [round_() for _ in range(10)])
    prof = device_breakdown("serve encoder, 10 batched rounds of 8 streams",
                            lambda: [round_() for _ in range(10)])
    lat = [v for r in results for v in r["lat"]]
    fin = [r["t_final"] for r in results]
    audio_s = float(sum(len(s_) for s_ in sigs[:S])) / fdlp_cfg.srate
    busy = "not measured" if prof is None else (
        f"{prof[1] / 10 / 1e3:.3f} ms device busy a round ({100 * prof[1] / prof[0]:.1f}% of "
        f"the profiled wall), {prof[2] / 10:.0f} device activities a round")
    log(f"[serve] wsj_fdlp_e2e {cfg.elayers}/{cfg.dlayers} layers adim {cfg.adim}, attn_chunk "
        f"{chunk} left {cfg.attn_left_chunks}; make_server(max_streams {S}, defer "
        f"{1e3 * SERVE_DEFER_S:.0f} ms): {S} concurrent streams of {audio_s:.1f} s audio in "
        f"{SERVE_PUSH_S} s messages, unpaced: {t_served:.2f} s wall = {audio_s / t_served:.1f} "
        f"audio s per wall s, {rounds} batched rounds (all streams, endpointing included); K1 "
        f"launches {serve_launches}")
    log(f"[serve] partial latency per message: median {1e3 * statistics.median(lat):.2f} ms, "
        f"p90 {1e3 * float(np.percentile(lat, 90)):.2f} ms over {len(lat)} messages; final "
        f"latency after eof: median {1e3 * statistics.median(fin):.2f} ms, max "
        f"{1e3 * max(fin):.2f} ms")
    log(f"[serve] encoder step at {S} full rows: {1e3 * t_round / 10:.3f} ms a round wall "
        f"(synchronised, host included); {busy}")
    log(f"[serve] featgen (StreamingFdlp, K1) per {SERVE_PUSH_S} s push: mean "
        f"{statistics.mean(push_ms):.3f} ms, median {statistics.median(push_ms):.3f} ms, max "
        f"{max(push_ms):.3f} ms over {len(push_ms)} pushes")
    log(f"[serve] finals vs OnlineASRPipeline on the card: {S - mismatched} of {S} "
        f"token-identical, {mismatched} differ, {near_frames} near-tie frames (top two within "
        f"{SERVE_NEAR_TIE}) in those; endpointing stream (endpoint_blanks {R}): "
        f"{len(ep_run['endpoints'])} mid-stream endpoints, segments equal the pipeline's")
    log(f"[serve] streamed vs batch features max|err| {feat_err:.3e}, allclose needs "
        f"rtol=atol >= {feat_need:.3e} (limit rtol {SERVE_FEAT_TOL['rtol']}, atol "
        f"{SERVE_FEAT_TOL['atol']}); "
        f"streamed vs offline chunked encoder memory max|err| {mem_err:.3e} (atol "
        f"{SERVE_MEM_ATOL}); transcribe CLI texts equal the pipeline's (K1 launches "
        f"{transcribe_launches})")
    log(f"[serve] recog_e2e, {SERVE_RECOG_UTTS} utterances, RNNLM, max_len "
        f"{SERVE_RECOG_MAX_LEN}: --jit_decode --batch_size {SERVE_RECOG_UTTS} {t_jit:.2f} s, "
        f"--streaming (beam) {t_str:.2f} s; {len(recog_gaps)} hypotheses differ, best-score "
        f"gaps {[f'{g:.2e}' for g in recog_gaps]}; phase 8 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return serve_launches, transcribe_launches, k1


def lm_train_phase(e2e, rng, dev, tmp):
    """The e2e recipe's LM stage (run_corpus.py stage 3): train_lm.main on
    the card at wsj_fdlp_e2e's LM width over phase 5's 52-token vocabulary,
    one epoch of seeded transcripts; one step card against CPU on the same
    weights and batch (loss 1e-5 relative, the Adam update 1e-3 x lr); a
    step's time and tokens/s; the final checkpoint loaded by the port's
    recog_e2e._load_lm and fused into one search of phase 5's model."""
    import os
    import string

    from speech_recognition_tools_tpu_torch.cli import train_lm
    from speech_recognition_tools_tpu_torch.cli.recog_e2e import _load_lm
    from speech_recognition_tools_tpu_torch.decode.beam_jit import tokens_to_list
    from speech_recognition_tools_tpu_torch.io.text import save_vocab
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam
    from speech_recognition_tools_tpu_torch.train.trainer import host_copy

    L = LM_TRAIN
    vocab = e2e["vocab"]
    V = len(vocab)
    letters = string.ascii_letters[: V - 4]
    text, vocab_path, store = (os.path.join(tmp, d) for d in ("lm_text", "lm_vocab.json", "lm"))
    texts = {f"lm{i:04d}": random_transcript(rng, letters, rng.randint(*LM_TEXT_CHARS))
             for i in range(LM_TEXTS)}
    with open(text, "w") as fh:
        fh.writelines(f"{k} {v}\n" for k, v in texts.items())
    save_vocab(vocab, vocab_path)
    argv = [text, store, "--vocab", vocab_path, "--device", str(dev)]
    argv += [a for k, v in L.items() for a in (f"--{k}", str(v))]
    t_main, nll = _synced(lambda: train_lm.main(argv))
    batches = list(train_lm.lm_batches(texts, vocab, L["batch_size"], L["bptt_len"], seed=0))
    assert len(nll) == L["epochs"] and all(np.isfinite(nll)), nll
    assert sorted(os.listdir(store)) == ["epoch_1", "final", "vocab.json"], os.listdir(store)

    def fresh(device):
        m = RNNLM(V, L["embed_dim"], L["hidden"], L["layers"], device=device)
        m.reset_parameters(torch.Generator().manual_seed(7))
        opt = ClipAdam(L["learning_rate"], None, inject=False)
        return m, opt, train_lm.make_train_step(m, opt)

    def on(device, toks, lens):
        return (torch.as_tensor(toks, device=device).long(),
                torch.as_tensor(lens, device=device).long())

    # one step, card against CPU: identical weights, the first sequences of a batch
    toks, lens = batches[0][0][:LM_STEP_CPU_SEQS], batches[0][1][:LM_STEP_CPU_SEQS]
    toks = toks[:, : int(lens.max())]
    steps = {}
    for device in ("cpu", dev):
        m, opt, step = fresh(device)
        params = dict(m.named_parameters())
        before = host_copy(params)
        _, loss = step(opt.init(params), *on(device, toks, lens))
        grads = {k: p.grad.detach().cpu() for k, p in params.items()}
        delta = {k: p.detach().cpu() - before[k] for k, p in params.items()}
        steps[str(device)] = (loss.item(), grads, delta)
    (l_c, gr_c, d_c), (l_g, gr_g, d_g) = steps["cpu"], steps[str(dev)]
    # the update the optimizer makes on the card against the one it makes on
    # the CPU from the same (the card's) gradients
    same = {k: v.clone() for k, v in before.items()}
    cpu_opt = ClipAdam(L["learning_rate"], None, inject=False)
    cpu_opt.apply(same, gr_g, cpu_opt.init(same))
    upd_err = max((d_g[k] - (same[k] - before[k])).abs().max().item() for k in d_g)
    e2e_err = max((d_g[k] - d_c[k]).abs().max().item() for k in d_c)
    g_worst = _worst_grad(gr_g, gr_c)
    assert _rel(l_g, l_c) <= 1e-5, (l_g, l_c)
    assert upd_err <= 1e-3 * L["learning_rate"], upd_err

    # a full batch of 64: ms a step, tokens a second, memory, profile
    m, opt, step = fresh(dev)
    params = dict(m.named_parameters())
    ost = opt.init(params)
    full = on(dev, *batches[0])
    ost, _ = step(ost, *full)
    torch.cuda.reset_peak_memory_stats()
    t_step, (ost, _) = wall_s(lambda: step(ost, *full))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = int((full[1] - 1).sum())
    device_breakdown(f"LM train step (B={len(batches[0][1])}, U={batches[0][0].shape[1]})",
                     lambda: step(ost, *full))

    # the final checkpoint, loaded as recog_e2e --lm_dir loads it, fused
    lm = _load_lm(store, device=dev)
    assert lm.output.weight.shape == (V, L["hidden"])
    t_s, (tk, sc) = _synced(lambda: beam_search_encoded(
        e2e["asr"], e2e["mem"], e2e["enc_len"], e2e["ctc"], lm=lm, max_len=LM_SEARCH_MAX_LEN,
        **E2E_BEAM))
    assert torch.isfinite(sc).all(), sc
    hyps = [tokens_to_list(tk[b], sc[b], e2e["asr"].cfg.eos_id) for b in range(len(sc))]
    log(f"[lm-train] wsj_fdlp_e2e LM: train_lm.main {L['layers']} x {L['hidden']} GRU, embed "
        f"{L['embed_dim']}, vocab {V}, {len(batches)} batches of {L['batch_size']} "
        f"(bptt_len {L['bptt_len']}), {L['epochs']} epoch: {t_main:.2f} s, epoch nll "
        + ", ".join(f"{v:.4f}" for v in nll))
    log(f"[lm-train] card vs cpu, one step on {LM_STEP_CPU_SEQS} sequences: loss {l_g:.6f} / "
        f"{l_c:.6f} (rel {_rel(l_g, l_c):.3e}, limit 1e-5); Adam update from the card's "
        f"gradients, card vs cpu: max|diff| {upd_err:.3e} (limit "
        f"{1e-3 * L['learning_rate']:.1e}); end to end max|update diff| {e2e_err:.3e}; the "
        f"gradient that differs most: {g_worst[0]}, |diff| {g_worst[1]:.3e} of the global "
        f"norm, {g_worst[2]:.3e} of its own")
    log(f"[lm-train] B={len(batches[0][1])} x U={batches[0][0].shape[1]} ({n_tok} target "
        f"tokens): {t_step * 1e3:.1f} ms a step = {n_tok / t_step:.0f} tokens/s; peak memory "
        f"{peak:.2f} GiB")
    log(f"[lm-train] final -> recog_e2e._load_lm -> beam 10 with phase 5's model on "
        f"{len(sc)} utterances, lm_weight 1.0, max_len {LM_SEARCH_MAX_LEN}: {t_s:.2f} s, "
        f"hypothesis lengths {[len(h) for h in hyps]}")


def _cost_of(dec, ll, words, nbest=50):
    """The decoding graph's best cost of the word-id sequence `words` under
    log-likelihoods `ll` (its entry in an N-best list), or None."""
    for ids, cost in dec.decode_nbest(ll, nbest, **HYBRID_DECODE):
        if ids == words:
            return cost
    return None


def _wfst_hyps_agree(tag, graph, hyp_card, hyp_cpu, ll_g, ll_c, keys):
    """decode_wfst's hypotheses over the card's and the CPU's arks: each
    hypothesis file holds every key, and a hypothesis that differs may cost
    at most DECODE_COST_TOL more under the CPU ark than the CPU's own
    (graph: build-graph's directory; ll_g / ll_c: {utt: log-likelihoods}).
    Returns ({"card": {utt: text}, "cpu": ...}, the keys that differ)."""
    from speech_recognition_tools_tpu_torch.decode.wfst import WfstDecoder

    hyp = {}
    for name, path in (("card", hyp_card), ("cpu", hyp_cpu)):
        with open(path) as f:
            hyp[name] = dict((ln.split(maxsplit=1) + [""])[:2] for ln in f.read().splitlines())
        assert sorted(hyp[name]) == sorted(keys), hyp[name]
    differ = [k for k in keys if hyp["card"][k] != hyp["cpu"][k]]
    if differ:
        dec = WfstDecoder(os.path.join(graph, "HCLG.txt"))
        w2i = {}
        with open(os.path.join(graph, "words.txt")) as f:
            for ln in f:
                w, i = ln.split()
                w2i[w] = int(i)
        for k in differ:
            ids = {n: [w2i[w] for w in hyp[n][k].split()] for n in ("card", "cpu")}
            costs = {(n, a): _cost_of(dec, lls[k], ids[n])
                     for n in ("card", "cpu") for a, lls in (("card", ll_g), ("cpu", ll_c))}
            log(f"[{tag}] {k} differs: card {hyp['card'][k]!r} / cpu "
                f"{hyp['cpu'][k]!r}; costs (hypothesis, ark): {costs}")
            worse = costs[("card", "cpu")]
            assert worse is not None and worse - costs[("cpu", "cpu")] <= DECODE_COST_TOL, (
                k, costs)
    return hyp, differ


def hybrid_decode_phase(rng, dev, tmp):
    """The hybrid recipe's decode end (run_corpus.py :696-702, :804-869) at
    timit_hybrid on phase 6's train_am checkpoint and egs: featgen (K1) ->
    egs of a decode set with phase 6's CMVN; compute_prior on phase 6's
    egs; train_ngram (order 3) on the decode set's transcripts over a
    synthetic lexicon of pdf ids below HYBRID_CLASSES; decode_wfst
    build-graph; dump_outputs --prior on the card and on the CPU (max|LL
    card - CPU| <= DECODE_LL_ATOL); decode_wfst decode over both arks, the
    card's hypotheses held to the CPU's (a differing one may cost at most
    DECODE_COST_TOL more under the CPU ark). Returns K1's launches over the
    path."""
    import os
    import pickle

    from speech_recognition_tools_tpu_torch.cli import (
        compute_prior,
        decode_wfst,
        dump_outputs,
        train_ngram,
    )
    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, load_egs
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

    hyb = FdlpConfig()

    def j(*parts):
        return os.path.join(tmp, *parts)

    xd, ld = speechlike_batch(rng, DECODE_UTTS, 2.0, 4.0)
    audio_s = float(ld.sum()) / hyb.srate
    words = [f"w{i:02d}" for i in range(DECODE_WORDS)]
    lexicon = {w: list(rng.randint(0, HYBRID_CLASSES, rng.randint(2, 5))) for w in words}
    keys = [f"dec{b:02d}" for b in range(DECODE_UTTS)]
    refs = {k: [words[i] for i in rng.randint(0, DECODE_WORDS, rng.randint(3, 9))]
            for k in keys}
    with open(j("dec_text"), "w") as f:
        f.writelines(f"{k} {' '.join(v)}\n" for k, v in refs.items())
    with open(j("lexicon.txt"), "w") as f:
        f.writelines(f"{w} {' '.join(map(str, p))}\n" for w, p in lexicon.items())
    t = {}

    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    feats, nfr = fdlp_spectrogram_batch(xd, ld, hyb, device=dev)
    cfg_egs, _ = load_egs(j("hyb_egs"))
    build_egs(((k, feats[b, : int(nfr[b])].cpu().numpy()) for b, k in enumerate(keys)),
              j("dec_egs"), cmvn=(np.asarray(cfg_egs.cmvn_mean), np.asarray(cfg_egs.cmvn_std)))
    t["featgen + egs"] = time.perf_counter() - t0
    t["compute_prior"], _ = _synced(lambda: compute_prior.main(
        [j("hyb_egs"), j("prior.pkl"), "--num_classes", str(HYBRID_CLASSES)]))
    with open(j("prior.pkl"), "rb") as f:
        assert np.isfinite(pickle.load(f)).all(), "a class phase 6's egs never label"
    t["train_ngram"], _ = _synced(lambda: train_ngram.main(
        [j("dec_text"), j("ngram"), "--order", "3"]))
    t["build-graph"], _ = _synced(lambda: decode_wfst.main(
        ["build-graph", j("ngram", "3gram.arpa.gz"), j("lexicon.txt"), j("graph"),
         "--states_per_phone", "1"]))
    dump = [j("hyb_am"), j("dec_egs")]
    prior = ["--prior", j("prior.pkl"), "--prior_weight", str(DECODE_PRIOR_WEIGHT)]
    t["dump_outputs (card)"], _ = _synced(lambda: dump_outputs.main(
        [*dump, j("ll_card"), *prior, "--device", str(dev)]))
    t["dump_outputs (cpu)"], _ = _synced(lambda: dump_outputs.main(
        [*dump, j("ll_cpu"), *prior, "--device", "cpu"]))
    decode = [a for k, v in HYBRID_DECODE.items() for a in (f"--{k}", str(v))]
    for name in ("card", "cpu"):
        t[f"decode ({name} ark)"], _ = _synced(lambda: decode_wfst.main(
            ["decode", j("graph"), j(f"ll_{name}.ark"), j(f"hyp_{name}.txt"), *decode,
             "--ref_text", j("dec_text")]))
    launches = lpc_cepstra.launches
    assert launches > 0, "the hybrid decode path did not launch K1"

    ll_g, ll_c = dict(read_ark(j("ll_card.ark"))), dict(read_ark(j("ll_cpu.ark")))
    assert list(ll_g) == list(ll_c) and sorted(ll_g) == keys
    assert all(ll_g[k].shape == (int(nfr[b]), HYBRID_CLASSES) for b, k in enumerate(keys))
    assert all(np.isfinite(v).all() for v in ll_g.values()), "non-finite log-likelihoods"
    ll_err = max(float(np.abs(ll_g[k] - ll_c[k]).max()) for k in keys)
    assert ll_err <= DECODE_LL_ATOL, ll_err
    hyp, differ = _wfst_hyps_agree("hybrid-decode", j("graph"), j("hyp_card.txt"),
                                   j("hyp_cpu.txt"), ll_g, ll_c, keys)
    dec_ms = t["decode (card ark)"] / DECODE_UTTS * 1e3
    rtf = (t["dump_outputs (card)"] + t["decode (card ark)"]) / audio_s
    log(f"[hybrid-decode] timit_hybrid decode set: {DECODE_UTTS} utterances of 2-4 s "
        f"({audio_s:.1f} s audio, {int(nfr.sum())} frames), lexicon of {DECODE_WORDS} words "
        f"over pdf ids < {HYBRID_CLASSES}, 3-gram of the decode transcripts, "
        f"acoustic_scale {HYBRID_DECODE['acoustic_scale']} beam {HYBRID_DECODE['beam']} "
        f"max_active {HYBRID_DECODE['max_active']}, prior_weight {DECODE_PRIOR_WEIGHT}: "
        f"K1 launches {launches}")
    log("[hybrid-decode] wall s by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    log(f"[hybrid-decode] max|LL card - cpu| {ll_err:.3e} (atol {DECODE_LL_ATOL}); "
        f"hypotheses identical {DECODE_UTTS - len(differ)} of {DECODE_UTTS}; decode "
        f"{dec_ms:.1f} ms per utterance; dump (card) + decode real-time factor {rtf:.4f}")
    log(f"[hybrid-decode] sample hypothesis {hyp['card'][keys[0]][:60]!r}")
    return launches


def ctc_only_check(e2e):
    """Phase 5's model at ctc_weight 1.0 (the joint search on CTC prefix
    scores alone, with the RNNLM): every score finite and no best
    hypothesis holds a blank."""
    from speech_recognition_tools_tpu_torch.decode.beam_jit import tokens_to_list

    asr = e2e["asr"]
    beam = dict(E2E_BEAM, ctc_weight=1.0)
    t_s, (tk, sc) = _synced(lambda: beam_search_encoded(
        asr, e2e["mem"], e2e["enc_len"], e2e["ctc"], lm=e2e["lm"], max_len=LM_SEARCH_MAX_LEN,
        **beam))
    hyps = [tokens_to_list(tk[b], sc[b], asr.cfg.eos_id) for b in range(len(sc))]
    assert torch.isfinite(sc).all(), sc
    assert all(asr.cfg.blank_id not in h for h in hyps) and any(hyps), hyps
    log(f"[ctc-only] ctc_weight 1.0, beam {beam['beam_size']}, RNNLM, max_len "
        f"{LM_SEARCH_MAX_LEN}, {len(sc)} utterances: {t_s:.2f} s, every score finite, best "
        f"scores {[round(float(v), 3) for v in sc.max(1).values]}, hypothesis lengths "
        f"{[len(h) for h in hyps]}, no blank in any")


def mfcc_phase(x, lens, rng, dev, tmp):
    """Phase 10 (a): the MFCC hybrid recipe at wsj_hybrid
    (recipes/configs/wsj_hybrid.json) on phase 3's utterances: the featgen
    CLIs on the card and on the CPU, --profile_dir, egs with per-utterance
    CMVN and context 4 recorded, train_am.main --arch rnn at full width.
    The MFCC path runs no K1."""
    from scipy.io.wavfile import write as wav_write

    from speech_recognition_tools_tpu_torch.cli import (
        compute_mel_spectrum,
        compute_mfcc,
        train_am,
    )
    from speech_recognition_tools_tpu_torch.dsp.mfcc import MfccConfig, mfcc_batch
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    srate = MFCC_FLAGS["srate"]
    wav_dir = os.path.join(tmp, "mfcc_wavs")
    os.makedirs(wav_dir)
    scp = os.path.join(tmp, "mfcc_wav.scp")
    with open(scp, "w") as fh:
        for b, n in enumerate(lens):
            path = os.path.join(wav_dir, f"utt{b:02d}.wav")
            wav_write(path, srate, np.round(x[b, :n]).astype(np.int16))
            fh.write(f"utt{b:02d} {path}\n")
    audio_s = float(lens.sum()) / srate
    mfcc_flags = [a for k, v in MFCC_FLAGS.items() for a in (f"--{k}", str(v))]

    def cli(mod, name, device, extra=()):
        out = os.path.join(tmp, f"{name}_{device}")
        t, _ = _synced(lambda: mod.main([scp, out, *extra, "--write_utt2num_frames",
                                         "--device", str(device)]))
        return t, dict(read_ark(out + ".ark"))

    parts = {}
    for name, mod, extra in (("mfcc", compute_mfcc, mfcc_flags),
                             ("melspec", compute_mel_spectrum, ())):
        cli(mod, name, dev, extra)  # cuFFT plans and first launches
        t_card, card = cli(mod, name, dev, extra)
        t_cpu, cpu = cli(mod, name, "cpu", extra)
        assert sorted(card) == sorted(cpu) and len(card) == len(lens)
        err = 0.0
        for k in cpu:
            assert card[k].shape == cpu[k].shape and np.isfinite(card[k]).all(), k
            assert np.allclose(card[k], cpu[k], **MFCC_TOL), (name, k)
            err = max(err, float(np.abs(card[k] - cpu[k]).max()))
        parts[name] = (t_card, t_cpu, err, card)
    mfcc = parts["mfcc"][3]
    assert mfcc["utt00"].shape[1] == 13
    cfg = MfccConfig(**MFCC_FLAGS)
    t_batch, _ = wall_s(lambda: mfcc_batch(x, lens, cfg, device=dev))
    dev_ms = cuda_ms(lambda: mfcc_batch(x, lens, cfg, device=dev), reps=5)
    prof = device_breakdown(f"mfcc_batch, {len(lens)} utterances",
                            lambda: mfcc_batch(x, lens, cfg, device=dev))
    prof_dir = os.path.join(tmp, "mfcc_profile")
    compute_mfcc.main([scp, os.path.join(tmp, "mfcc_prof"), *mfcc_flags, "--profile_dir",
                       prof_dir, "--device", str(dev)])
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    assert traces, f"--profile_dir wrote no trace: {os.listdir(prof_dir)}"
    trace_mb = os.path.getsize(os.path.join(prof_dir, traces[0])) / 2**20

    # egs as run_corpus.py:654-658 builds them: per-utterance CMVN, context 4
    egs, store = os.path.join(tmp, "mfcc_egs"), os.path.join(tmp, "mfcc_am")
    utts, labels = [], {}
    for k, v in sorted(mfcc.items()):
        sd = v.std(0)
        v = (v - v.mean(0)) / np.where(sd == 0, 1.0, sd)
        for c in range(MFCC_COPIES):
            utts.append((f"{k}c{c}", v))
            labels[f"{k}c{c}"] = rng.randint(0, MFCC_CLASSES, v.shape[0])
    build_egs(iter(utts), egs, labels, context=MFCC_CONTEXT, num_targets=MFCC_CLASSES)
    with open(os.path.join(egs, "egs.config")) as fh:
        assert json.load(fh)["context"] == MFCC_CONTEXT
    H = MFCC_TRAIN
    argv = [egs, store, "--arch", "rnn", "--device", str(dev)]
    argv += [a for k, v in H.items() for a in (f"--{k}", str(v))]
    t_train, st = _synced(lambda: train_am.main(argv))
    assert len(st.history) == H["epochs"] and all(
        np.isfinite(h["train_loss"]) for h in st.history), st.history
    assert "final" in os.listdir(store), os.listdir(store)

    # one step card against CPU on the same weights: the 4 shortest
    # utterances, cut to their first MFCC_STEP_FRAMES frames
    args = train_am.get_parser().parse_args(argv)
    loss_fn = train_am.make_loss(args)
    def cut(b):
        return dict(b, feats=b["feats"][:, :MFCC_STEP_FRAMES],
                    labels=b["labels"][:, :MFCC_STEP_FRAMES],
                    lengths=np.minimum(b["lengths"], MFCC_STEP_FRAMES))

    small = cut(next(iter_egs_batches(egs, 4)))
    step = {}
    for device in ("cpu", dev):
        m = RNNClassifier(13, H["num_layers"], H["hidden_dim"], MFCC_CLASSES, device=device)
        m.reset_parameters(torch.Generator().manual_seed(5))
        tr = Trainer(m, loss_fn, TrainConfig(learning_rate=H["learning_rate"]))
        st1 = tr.init_state()
        batch = {k: torch.as_tensor(v, device=device) for k, v in small.items() if k != "keys"}
        loss, _, gnorm = tr.train_step(st1, batch)
        step[str(device)] = (loss.item(), gnorm)
    (l_c, g_c), (l_g, g_g) = step["cpu"], step[str(dev)]
    assert _rel(l_g, l_c) <= 1e-5, (l_g, l_c)
    batch64 = next(iter_egs_batches(egs, H["batch_size"]))
    full = {k: torch.as_tensor(v, device=dev) for k, v in batch64.items() if k != "keys"}
    short = {k: torch.as_tensor(v, device=dev) for k, v in cut(batch64).items() if k != "keys"}
    t_step, _ = _synced(lambda: tr.train_step(st1, full))
    step_prof = device_breakdown(
        f"wsj_hybrid train step (B={H['batch_size']}, {MFCC_STEP_FRAMES} frames)",
        lambda: tr.train_step(st1, short))
    busy = "not measured" if prof is None else (
        f"device busy {prof[1] / 1e3:.2f} ms of {prof[0] / 1e3:.2f} ms profiled "
        f"({100 * prof[1] / prof[0]:.1f}%)")
    for name, (t_card, t_cpu, err, _) in parts.items():
        log(f"[mfcc] {name} CLI, {len(lens)} wavs ({audio_s:.1f} s audio): card {t_card:.3f} s = "
            f"{audio_s / t_card:.1f}x real time (second call), cpu {t_cpu:.3f} s; max|card - "
            f"cpu| {err:.3e} (rtol {MFCC_TOL['rtol']}, atol {MFCC_TOL['atol']})")
    log(f"[mfcc] mfcc_batch alone (wsj_hybrid, {len(lens)} x {lens.min() / srate:.1f}-"
        f"{lens.max() / srate:.1f} s): {t_batch * 1e3:.2f} ms wall = {audio_s / t_batch:.1f}x "
        f"real time, {dev_ms:.2f} ms by CUDA events (host copy included); {busy}; "
        f"--profile_dir trace {traces[0]} ({trace_mb:.1f} MiB)")
    sbusy = "not measured" if step_prof is None else (
        f"at {MFCC_STEP_FRAMES} frames {step_prof[0] / 1e3:.1f} ms profiled, "
        f"{100 * step_prof[1] / step_prof[0]:.1f}% busy, {step_prof[2]} device activities")
    log(f"[mfcc-train] wsj_hybrid: egs of {len(utts)} utterances (per-utterance CMVN, context "
        f"{MFCC_CONTEXT} recorded) -> train_am.main --arch rnn {H['num_layers']} x "
        f"{H['hidden_dim']} GRU, 13 features, {MFCC_CLASSES} classes, batch {H['batch_size']}, "
        f"1 epoch: {t_train:.2f} s, loss {st.history[0]['train_loss']:.4f}; card vs cpu one "
        f"step on 4 utterances x {MFCC_STEP_FRAMES} frames: loss {l_g:.6f} / {l_c:.6f} "
        f"(rel {_rel(l_g, l_c):.3e}, limit "
        f"1e-5), grad norm rel {_rel(g_g, g_c):.3e}; B={H['batch_size']} step "
        f"({int(full['feats'].shape[1])} frames padded) {t_step * 1e3:.1f} ms wall; {sbusy}; "
        f"phase 10 (a) took "
        f"{time.perf_counter() - t_phase:.1f} s")


def conformer_phase(x, lens, fdlp_cfg, feats, nfr, rng, dev, tmp):
    """Phase 10 (b): the conformer of wsj_fdlp_conformer_e2e on phase 3's
    batch (`feats`, `nfr`: its K1 features): recognition through
    recognize_batch, training through train_e2e.main on phase 7's egs and
    recog_e2e.main on the checkpoint, and streaming with attn_chunk 16 from
    a model directory. Returns K1's launches over (recognize_batch, the
    OnlineASRPipeline streams)."""
    import string

    from speech_recognition_tools_tpu_torch.cli import recog_e2e, train_e2e
    from speech_recognition_tools_tpu_torch.decode.beam_jit import tokens_to_list
    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp
    from speech_recognition_tools_tpu_torch.infer.recognize import recognize_batch
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import (
        OnlineASRPipeline,
        StreamBatcher,
        StreamingRecognizer,
    )
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        rnnlm_from_jax,
        transformer_asr_from_jax,
    )
    from speech_recognition_tools_tpu_torch.io.text import (
        build_char_vocab,
        decode_tokens,
        save_vocab,
    )
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        ConformerBlock,
        TransformerASR,
        TransformerASRConfig,
    )
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn, cmvn_stats_masked

    t_phase = time.perf_counter()
    cfg = TransformerASRConfig(**CONF_AM)
    idim, V, eos = fdlp_cfg.nfilters, cfg.vocab_size, cfg.eos_id
    params = random_asr_params(rng, cfg, idim)
    lm_params = random_rnnlm_params(rng, V, cfg.adim, E2E_LM_HIDDEN)

    def build(device, c=cfg):
        asr = TransformerASR(c, idim, device=device)
        asr.load_state_dict(transformer_asr_from_jax(params))
        lm = RNNLM(V, cfg.adim, E2E_LM_HIDDEN, 1, device=device)
        lm.load_state_dict(rnnlm_from_jax(lm_params))
        return asr.eval(), lm.eval()

    asr, lm = build(dev)
    assert all(isinstance(m, ConformerBlock) for m in asr.encoder.layers)
    vocab = build_char_vocab([string.ascii_letters[: V - 4]])
    mean, std = cmvn_stats_masked(feats, nfr)
    B = len(lens)
    audio_s = float(lens.sum()) / fdlp_cfg.srate

    def front(c):
        f, n = fdlp_spectrogram_batch(x, lens, c, device=dev)
        return apply_cmvn(f, mean, std), n

    def encode(f, n, model=asr):
        with torch.no_grad():
            return model.encode(f, n)

    def search(mem, enc_len, ctc):
        with torch.no_grad():
            return beam_search_encoded(asr, mem, enc_len, ctc, lm=lm, max_len=CONF_MAX_LEN,
                                       **E2E_BEAM)

    # the main path, counted, through the entry point a user calls
    lpc_cepstra.launches = 0
    K2.reset()
    GRAPHS.reset()
    t_first, texts = _synced(lambda: recognize_batch(
        x, lens, fdlp_cfg, mean, std, asr, vocab, lm=lm, **E2E_BEAM, max_len=CONF_MAX_LEN,
        device=dev))
    launches = lpc_cepstra.launches
    assert launches > 0, "the conformer path did not launch K1"
    K2.read("conformer_e2e")
    GRAPHS.read("conformer_e2e")
    t_front, (f, n) = wall_s(lambda: front(fdlp_cfg))
    t_enc, (mem, enc_len, ctc) = wall_s(lambda: encode(f, n))
    # recognize_batch has just run this search: no warm-up call
    t_beam, (toks, scores) = wall_s(lambda: search(mem, enc_len, ctc), repeats=1, warmup=False)
    hyps = [tokens_to_list(toks[b], scores[b], eos) for b in range(B)]
    assert texts == [decode_tokens(h, vocab) for h in hyps], "recognize_batch != its parts"
    assert torch.isfinite(scores).all() and torch.isfinite(valid_rows(mem, enc_len)).all()
    steps = int((toks[0, 0] >= 0).sum()) - 1
    f_s, n_s = front(FdlpConfig(**{**fdlp_cfg.__dict__, "lpc_backend": "scan"}))
    assert torch.equal(n, n_s)
    _, _, ctc_s = encode(f_s, n_s)
    ctc_err = (valid_rows(torch.log_softmax(ctc, -1), enc_len)
               - valid_rows(torch.log_softmax(ctc_s, -1), enc_len)).abs().max().item()
    assert ctc_err <= E2E_CTC_TOL, ctc_err
    cpu_asr, _ = build("cpu")
    two = n[:2].cpu()
    f2 = f[:2, : int(two.max())]
    m_c, l_c, c_c = encode(f2.cpu(), two, model=cpu_asr)
    m_g, l_g, c_g = encode(f2, n[:2])
    assert torch.equal(l_g.cpu(), l_c)
    enc_err = max((valid_rows(g.cpu(), l_c) - valid_rows(c, l_c)).abs().max().item()
                  for g, c in ((m_g, m_c), (c_g, c_c)))
    assert enc_err < 1e-4, enc_err
    prof = device_breakdown("conformer encoder batch", lambda: encode(f, n))
    busy = "not measured" if prof is None else (
        f"device busy {prof[1] / 1e3:.2f} ms of {prof[0] / 1e3:.2f} ms profiled "
        f"({100 * prof[1] / prof[0]:.1f}%), {prof[2]} device activities")
    total = t_front + t_enc + t_beam
    log(f"[conformer] wsj_fdlp_conformer_e2e {B} x {lens.min() / 16000:.1f}-"
        f"{lens.max() / 16000:.1f} s ({audio_s:.1f} s audio), {cfg.elayers} conformer layers "
        f"(conv_kernel {cfg.conv_kernel}) / {cfg.dlayers} decoder, beam "
        f"{E2E_BEAM['beam_size']}, RNNLM 1 x {E2E_LM_HIDDEN}, max_len {CONF_MAX_LEN}: K1 "
        f"launches {launches}; first recognize_batch {t_first:.2f} s; per batch front-end "
        f"{t_front * 1e3:.2f} ms, encoder {t_enc * 1e3:.2f} ms ({busy}), beam search "
        f"{t_beam * 1e3:.1f} ms ({steps} steps); total {total * 1e3:.1f} ms = "
        f"{audio_s / total:.1f}x real time")
    log(f"[conformer] max|CTC logp(K1) - CTC logp(plain)| {ctc_err:.3e} (limit "
        f"{E2E_CTC_TOL}); encoder cuda vs cpu max|err| {enc_err:.3e} (atol 1e-4)")

    # training: train_e2e.main --encoder_type conformer on phase 7's egs
    egs7, text7 = os.path.join(tmp, "e2e_egs"), os.path.join(tmp, "e2e_text")
    store = os.path.join(tmp, "conf_am")
    argv = [egs7, text7, store, "--device", str(dev)]
    argv += [a for k, v in {**CONF_AM, **CONF_TRAIN}.items() if k != "vocab_size"
             for a in (f"--{k}", str(v))]
    t_train, losses = _synced(lambda: train_e2e.main(argv))
    assert len(losses) == CONF_TRAIN["epochs"] and all(np.isfinite(losses)), losses
    _, meta = load_checkpoint(os.path.join(store, "final_avg"))
    assert meta["encoder_type"] == "conformer" and meta["conv_kernel"] == cfg.conv_kernel
    egs4 = os.path.join(tmp, "conf_egs4")
    mean_np, std_np = mean.cpu().numpy(), std.cpu().numpy()
    build_egs(((f"utt{b}", feats[b, : int(nfr[b])].cpu().numpy()) for b in range(4)), egs4,
              cmvn=(mean_np, std_np))
    t_recog, rec = _synced(lambda: recog_e2e.main(
        [store, egs4, os.path.join(tmp, "conf_hyp"), "--jit_decode", "--batch_size", "4",
         "--max_len", str(CONF_MAX_LEN), "--device", str(dev)]))
    assert sorted(rec) == [f"utt{b}" for b in range(4)], rec
    log(f"[conformer-train] train_e2e.main --encoder_type conformer --conv_kernel "
        f"{cfg.conv_kernel} at full width, 1 epoch of 2 batches of {CONF_TRAIN['batch_size']}: "
        f"{t_train:.2f} s, loss {losses[0]:.4f}; final_avg -> recog_e2e.main on 4 utterances "
        f"(beam 10, max_len {CONF_MAX_LEN}): {t_recog:.2f} s, {rec['utt0'][:40]!r}")

    # streaming: a model directory with the recipes' streaming setting
    scfg = TransformerASRConfig(**CONF_AM, **SERVE_CHUNK)
    sparams = {"params": {**params["params"], "ctc_head": {
        "kernel": params["params"]["ctc_head"]["kernel"],
        "bias": params["params"]["ctc_head"]["bias"].copy()}}}
    sparams["params"]["ctc_head"]["bias"][scfg.blank_id] += SERVE_BLANK_BIAS
    model_dir = os.path.join(tmp, "conf_stream")
    save_checkpoint(model_dir, "final_avg", sparams, dict(
        model_class="TransformerASR", **CONF_AM, **SERVE_CHUNK, mtlalpha=0.3, lsm_weight=0.1,
        feature_dim=idim))
    save_vocab(vocab, os.path.join(model_dir, "vocab.json"))
    np.savez(os.path.join(model_dir, "cmvn.npz"), mean=mean_np, std=std_np)
    frontend = {k: getattr(fdlp_cfg, k) for k in ("srate", "nfilters", "coeff_num",
                                                  "coeff_range", "order", "fduration")}
    with open(os.path.join(model_dir, "serving.json"), "w") as fh:
        json.dump({"frontend": {"type": "fdlp", **frontend}, "cmvn": "cmvn.npz",
                   "cmvn_mode": "global"}, fh)
    pipe = OnlineASRPipeline.from_model_dir(model_dir, device=dev)
    smodel, _, _ = recog_e2e._load(model_dir, "final_avg", device=dev)
    assert smodel.cfg.encoder_type == "conformer" and smodel.cfg.attn_chunk == scfg.attn_chunk
    mem_err = 0.0
    for b in range(2):
        fb = ((feats[b, : int(nfr[b])] - mean) / std).cpu().numpy()
        sr = StreamingRecognizer(smodel)
        for off in range(0, fb.shape[0], 25):
            sr.push(fb[off : off + 25])
        sr.finish()
        with torch.no_grad():
            m, ln, _ = smodel.encode(torch.as_tensor(fb[None], device=dev),
                                     torch.tensor([fb.shape[0]], device=dev))
        assert sr.enc_len == int(ln[0])
        mem_err = max(mem_err, float(np.abs(sr.memory - m[0, : sr.enc_len].cpu().numpy()).max()))
    assert mem_err <= SERVE_MEM_ATOL, mem_err

    # CONF_STREAMS streams through CONF_SLOTS rows: the first finishes, the
    # last takes its row; each final against OnlineASRPipeline on its audio
    step = int(SERVE_PUSH_S * fdlp_cfg.srate)
    sigs = [x[b, : int(lens[b])] for b in range(CONF_STREAMS)]
    lpc_cepstra.launches = 0
    want, rows = [], []
    for sig in sigs:
        tok, ctc_rows = _pipeline_run(pipe, sig, step)
        want.append(tok)
        rows.append(ctc_rows)
    stream_launches = lpc_cepstra.launches
    assert stream_launches > 0, "the conformer stream did not launch K1"
    sfeats = []
    for sig in sigs:
        sf = StreamingFdlp(fdlp_cfg, device=dev)
        outs = [sf.process(sig[off : off + step]) for off in range(0, len(sig), step)]
        outs.append(sf.finish())
        sfeats.append((np.concatenate(outs) - mean_np) / std_np)
    sb = StreamBatcher(smodel, max_streams=CONF_SLOTS)
    sids = [sb.open() for _ in range(CONF_SLOTS)]
    sb.push(sids[0], sfeats[0])
    first_slot = sb.state(sids[0]).slot
    got = {0: sb.finish(sids[0])}
    sids.append(sb.open())
    assert sb.state(sids[-1]).slot == first_slot, "the freed row was not reused"
    t_rounds = time.perf_counter()
    offs = [0] * CONF_STREAMS
    while any(offs[i] < len(sfeats[i]) for i in range(1, CONF_STREAMS)):
        for i in range(1, CONF_STREAMS):
            if offs[i] < len(sfeats[i]):
                sb.push(sids[i], sfeats[i][offs[i] : offs[i] + 25])
                offs[i] += 25
    for i in range(1, CONF_STREAMS):
        got[i] = sb.finish(sids[i])
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t_rounds
    mismatched = 0
    for i in range(CONF_STREAMS):
        if got[i] != want[i]:
            mismatched += 1
            assert _ctc_near_ties(rows[i]) > 0, (i, got[i], want[i])
    log(f"[conformer-stream] attn_chunk {scfg.attn_chunk} left {scfg.attn_left_chunks}, "
        f"causal conv tail {scfg.conv_kernel - 1}: streamed vs offline chunked memory max|err| "
        f"{mem_err:.3e} (atol {SERVE_MEM_ATOL}); {CONF_STREAMS} streams through "
        f"{CONF_SLOTS} rows (one reused): {CONF_STREAMS - mismatched} of {CONF_STREAMS} finals "
        f"token-identical to OnlineASRPipeline ({mismatched} at CTC near-ties), "
        f"{sb.rounds} rounds in {t_rounds:.2f} s; K1 launches over the pipeline streams "
        f"{stream_launches}; phase 10 (b) took {time.perf_counter() - t_phase:.1f} s")
    return launches, stream_launches


def high_precision_phase(x, lens, fdlp_cfg, fa, na, dev):
    """Phase 11 (a): wsj_fdlp_e2e's front-end at precision 'high' on phase
    3's batch, float64 on the card: no K1 launch (K1 is float32-only), card
    against CPU, 'blocked:15' (the default) against 'scan', high against
    phase 3's fast features; ms a batch, the LPC stage's ms by backend, and
    a profile."""
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        _lpc_cepstra,
        fdlp_lags,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

    t_phase = time.perf_counter()
    hi = FdlpConfig(**{**fdlp_cfg.__dict__, "precision": "high"})
    scan = FdlpConfig(**{**hi.__dict__, "lpc_backend": "scan"})
    audio_s = float(lens.sum()) / hi.srate
    lpc_cepstra.launches = 0
    t_hi, (fh, nh) = wall_s(lambda: fdlp_spectrogram_batch(x, lens, hi, device=dev), repeats=2)
    assert lpc_cepstra.launches == 0, "the float64 path launched K1"
    assert torch.equal(nh, na) and fh.shape == fa.shape and fh.dtype == torch.float32
    vh, vf = valid_rows(fh, nh), valid_rows(fa, na)
    assert torch.isfinite(vh).all()
    hf_diff = (vh - vf).abs().flatten()
    hf_err, hf_p999 = hf_diff.max().item(), torch.quantile(hf_diff[:2**24], 0.999).item()
    assert hf_err <= HIGH_VS_FAST_MAX and hf_p999 <= HIGH_VS_FAST_P999, (hf_err, hf_p999)
    t_scan, _ = wall_s(lambda: fdlp_spectrogram_batch(x, lens, scan, device=dev), repeats=1)
    f64 = dict(dtype=torch.float64, device=dev)
    fb64, nb64 = fdlp_spectrogram_batch(x, lens, hi, **f64)
    fs64, ns64 = fdlp_spectrogram_batch(x, lens, scan, **f64)
    assert torch.equal(ns64, nh) and torch.equal(nb64, nh)
    bs_err = (valid_rows(fs64, ns64) - valid_rows(fb64, nb64)).abs().max().item()
    assert bs_err <= HIGH_TOL, bs_err

    # card against CPU on the first utterances (the CPU's float64 lags are slow)
    k = HIGH_CPU_UTTS
    xs, ls = x[:k, : int(lens[:k].max())], lens[:k]
    fg, ng = fdlp_spectrogram_batch(xs, ls, hi, **f64)
    t_cpu, (fc, nc) = _synced(lambda: fdlp_spectrogram_batch(xs, ls, hi, dtype=torch.float64,
                                                             device="cpu"))
    assert torch.equal(ng.cpu(), nc)
    cc_err = (valid_rows(fg.cpu(), nc) - valid_rows(fc, nc)).abs().max().item()
    assert cc_err <= HIGH_TOL, cc_err

    # the float64 LPC stage alone, by backend, on the batch's own lags
    r, _ = fdlp_lags(x, lens, hi, device=dev)
    assert r.dtype == torch.float64
    lpc_ms = {b: cuda_ms(lambda b=b: _lpc_cepstra(r, hi.order, hi.coeff_num, b), reps=1,
                         repeats=3) for b in ("blocked:15", "scan")}
    t_lags, _ = wall_s(lambda: fdlp_lags(x, lens, hi, device=dev), repeats=2)
    device_breakdown("fdlp high, wsj_fdlp_e2e batch",
                     lambda: fdlp_spectrogram_batch(x, lens, hi, device=dev))
    log(f"[high] wsj_fdlp_e2e precision high, {len(lens)} x {lens.min() / 16000:.1f}-"
        f"{lens.max() / 16000:.1f} s ({audio_s:.1f} s audio), {r.shape[0] * r.shape[1]} "
        f"float64 LPC rows: {t_hi * 1e3:.2f} ms/batch = {audio_s / t_hi:.1f}x real time "
        f"(fast path, phase 3: see [featgen]); lags alone {t_lags * 1e3:.2f} ms; LPC stage "
        f"blocked:15 {lpc_ms['blocked:15']:.2f} ms, scan {lpc_ms['scan']:.2f} ms; whole batch "
        f"with scan {t_scan * 1e3:.2f} ms; K1 launches 0")
    log(f"[high] max|high - fast(K1)| {hf_err:.3e} (limit {HIGH_VS_FAST_MAX}), p99.9 "
        f"{hf_p999:.3e} (limit {HIGH_VS_FAST_P999}); at float64 I/O max|blocked:15 - scan| "
        f"{bs_err:.3e}, max|card - cpu| on {k} utterances {cc_err:.3e} (limit {HIGH_TOL}); "
        f"CPU {t_cpu:.2f} s for them; phase 11 (a) took {time.perf_counter() - t_phase:.1f} s")


def modspec_phase(x, lens, dev, tmp):
    """Phase 11 (b): compute_modulation_spectrum.main at its CLI defaults on
    phase 3's 32 utterances written as wavs, batch 8, on the card: the
    default, --set_unity_gain, --complex_modulation and --complex_modulation
    --absolute_value, each held card against CPU on the first utterances;
    K1 counted (real float32 lags launch it; the plain version is never
    reached there), K1 against its plain version on the path's own lags
    (unity gain on and off), its ms and bound at the path's shape, the
    batch's and the CLI's real-time factors and a profile. Returns K1's
    launches over the default run."""
    from scipy.io.wavfile import write as wav_write

    from speech_recognition_tools_tpu_torch.cli import compute_modulation_spectrum as cli_mod
    from speech_recognition_tools_tpu_torch.dsp import modspec
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.ops import lpc_cepstra as k1_mod
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )

    t_phase = time.perf_counter()
    cfg = modspec.ModSpecConfig()
    srate = cfg.srate
    wav_dir = os.path.join(tmp, "modspec_wavs")
    os.makedirs(wav_dir)
    scps = {}
    for name, utts in (("all", range(len(lens))), ("cpu", range(MODSPEC_CPU_UTTS))):
        scps[name] = os.path.join(tmp, f"modspec_{name}.scp")
        with open(scps[name], "w") as fh:
            for b in utts:
                path = os.path.join(wav_dir, f"utt{b:02d}.wav")
                if not os.path.exists(path):
                    wav_write(path, srate, np.round(x[b, : lens[b]]).astype(np.int16))
                fh.write(f"utt{b:02d} {path}\n")
    audio_s = float(lens.sum()) / srate

    plain_calls = []

    def counted_plain(*a, **kw):
        plain_calls.append(a[0].device.type)
        return lpc_cepstra_reference(*a, **kw)

    def cli(name, device, scp):
        out = os.path.join(tmp, f"modspec_{name}_{device}")
        t, _ = _synced(lambda: cli_mod.main([scp, out, *MODSPEC_RUNS[name],
                                             "--write_utt2num_frames", "--device",
                                             str(device)]))
        return t, dict(read_ark(out + ".ark"))

    cli("default", dev, scps["all"])  # cuFFT plans and first launches
    rows, launches = {}, {}
    for name in MODSPEC_RUNS:
        complex_run = "--complex_modulation" in MODSPEC_RUNS[name]
        plain_calls.clear()
        lpc_cepstra.launches = 0
        modspec.lpc_cepstra_reference = k1_mod.lpc_cepstra_reference = counted_plain
        try:
            t_card, card = cli(name, dev, scps["all"])
        finally:
            modspec.lpc_cepstra_reference = k1_mod.lpc_cepstra_reference = (
                lpc_cepstra_reference)
        launches[name] = lpc_cepstra.launches
        if complex_run:  # complex lags: the plain loops on the card, no K1
            assert launches[name] == 0 and plain_calls and set(plain_calls) == {dev.type}
        else:  # real float32 lags: K1 only
            assert launches[name] > 0, f"modspec {name} launched no K1"
            assert not plain_calls, f"modspec {name} reached the plain version"
        t_cpu, cpu = cli(name, "cpu", scps["cpu"])
        assert len(card) == len(lens) and set(cpu) <= set(card)
        for v in card.values():
            assert np.isfinite(v).all() and v.shape[1] == cfg.nfilters * (
                2 * cfg.coeff_num if name == "complex" else cfg.coeff_num)
        got = np.concatenate([card[k].ravel() for k in sorted(cpu)])
        ref = np.concatenate([cpu[k].ravel() for k in sorted(cpu)])
        assert np.isfinite(ref).all()
        scale = float(np.percentile(np.abs(ref), 99.9))
        d = np.abs(got - ref) / scale
        share = float((d > MODSPEC_COMPLEX_TOL).mean())
        if complex_run:
            assert share <= MODSPEC_COMPLEX_SHARE, (name, share, d.max())
        else:
            assert d.max() <= MODSPEC_TOL, (name, d.max(), scale)
        rows[name] = (t_card, t_cpu, float(d.max()), float(np.percentile(d, 99)), share,
                      scale)

    # complex modulation in float64, card against CPU; the card's float32
    # features against its float64 ones
    k = MODSPEC_CPU_UTTS
    xs, ls = x[:k, : int(lens[:k].max())], lens[:k]
    ccfg = modspec.ModSpecConfig(complex_modulation=True)
    f64g, n64 = modspec.modulation_spectrum_batch(xs, ls, ccfg, dtype=torch.float64,
                                                  device=dev)
    f64c, _ = modspec.modulation_spectrum_batch(xs, ls, ccfg, dtype=torch.float64,
                                                device="cpu")
    f32g, _ = modspec.modulation_spectrum_batch(xs, ls, ccfg, device=dev)
    v64g, v64c = valid_rows(f64g, n64).cpu(), valid_rows(f64c, n64.cpu())
    v32g = valid_rows(f32g, n64).cpu().double()
    scale64 = torch.quantile(v64c.abs().flatten()[:2**24], 0.999).item()
    err64 = (v64g - v64c).abs().max().item() / scale64
    assert torch.isfinite(v64g).all() and err64 <= MODSPEC_F64_TOL, err64
    d32 = (v32g - v64g).abs() / scale64
    share32 = (d32 > MODSPEC_COMPLEX_TOL).double().mean().item()

    # the batch alone, K1 at the path's own lags, a profile
    B = 8
    xb, lb = x[:B, : int(lens[:B].max())], lens[:B]
    batch_audio = float(lb.sum()) / srate
    t_batch, (fb, nb) = wall_s(lambda: modspec.modulation_spectrum_batch(xb, lb, cfg,
                                                                         device=dev))
    r, _ = modspec.modulation_spectrum_lags(xb, lb, cfg, device=dev)
    P = r.shape[0]
    k1 = {}
    for unity in (False, True):
        got = lpc_cepstra(r, cfg.order, cfg.coeff_n, unity_gain=unity)
        ref = lpc_cepstra_reference(r, cfg.order, cfg.coeff_n, unity_gain=unity)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        k_err, k_t, k_rel = cep_agreement(f"modspec lags P={P} unity_gain={unity}", got, ref)
        assert k_t <= MODSPEC_K1_TOL and k_rel <= MODSPEC_K1_REL, (unity, k_t, k_rel)
        k1[unity] = (k_err,
                     graph_ms(lambda u=unity: lpc_cepstra(r, cfg.order, cfg.coeff_n,
                                                          unity_gain=u)),
                     cuda_ms(lambda u=unity: lpc_cepstra_reference(r, cfg.order, cfg.coeff_n,
                                                                   unity_gain=u),
                             reps=1, repeats=3))
    bound, by = bound_ms(*k1_work(P, cfg.order, cfg.coeff_n))
    device_breakdown(f"modulation_spectrum_batch, {B} utterances",
                     lambda: modspec.modulation_spectrum_batch(xb, lb, cfg, device=dev))
    for name, (t_card, t_cpu, err, p99, share, scale) in rows.items():
        log(f"[modspec] {name}: CLI on the card {t_card:.2f} s for {len(lens)} utterances "
            f"({audio_s:.1f} s audio) = {audio_s / t_card:.1f}x real time, K1 launches "
            f"{launches[name]}; CPU {t_cpu:.2f} s for {MODSPEC_CPU_UTTS}; |card - cpu| / scale "
            f"({scale:.3e}): max {err:.3e}, p99 {p99:.3e}, share > {MODSPEC_COMPLEX_TOL} "
            f"{share:.2e}")
    log(f"[modspec] complex float64, {k} utterances: max|card - cpu| / scale {err64:.3e} "
        f"(limit {MODSPEC_F64_TOL}); card float32 against card float64: max {d32.max():.3e}, "
        f"share > {MODSPEC_COMPLEX_TOL} {share32:.2e}")
    for unity, (k_err, k_ms, p_ms) in k1.items():
        log(f"[k1] modspec lags P={P} order={cfg.order} lim={cfg.coeff_n} unity_gain={unity}: "
            f"max|kernel - plain|={k_err:.3e} kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
            f"bound_ms={bound:.5f} ({by}) share_of_bound={bound / k_ms:.3f}")
    log(f"[modspec] modulation_spectrum_batch, {B} utterances ({batch_audio:.1f} s audio, "
        f"{P} LPC rows): {t_batch * 1e3:.2f} ms/batch = {batch_audio / t_batch:.1f}x real "
        f"time; phase 11 (b) took {time.perf_counter() - t_phase:.1f} s")
    return launches["default"]


def incremental_phase(e2e, dev):
    """Phase 11 (c): phase 5's search (beam 10, ctc_weight 0.3, the RNNLM,
    max_len INCR_MAX_LEN) on phase 5's 32 encoded utterances, the fixed-buffer
    KV-cached step replayed as a CUDA graph (beam_search_encoded) against the
    eager loop's full-prefix pass (beam_search_eager): the same hypotheses
    (a difference only at a near-tie: the best scores within
    INCR_SCORE_REL) and best scores within INCR_SCORE_REL, relative; ms a
    step both ways."""
    from speech_recognition_tools_tpu_torch.decode.beam_jit import beam_search_eager, tokens_to_list

    t_phase = time.perf_counter()
    asr, lm = e2e["asr"], e2e["lm"]
    mem, enc_len, ctc = e2e["mem_all"], e2e["enc_len_all"], e2e["ctc_all"]
    eos = asr.cfg.eos_id

    def search(fn, n=len(enc_len), max_len=INCR_MAX_LEN):
        return fn(asr, mem[:n], enc_len[:n], ctc[:n], lm=lm, max_len=max_len, **E2E_BEAM)

    search(beam_search_encoded, max_len=2)  # captures the graph the timed search replays
    search(beam_search_eager, n=2, max_len=5)  # first launches of the step's shapes
    t_full, (tf, sf) = _synced(lambda: search(beam_search_eager))
    K2.reset()
    GRAPHS.reset()
    t_inc, (ti, si) = _synced(lambda: search(beam_search_encoded))
    K2.read("incremental", search_steps(ti))
    GRAPHS.read("incremental", 0)
    steps = search_steps(tf)
    assert torch.isfinite(si).all() and ti.shape == tf.shape
    B = len(enc_len)
    hf = [tokens_to_list(tf[b], sf[b], eos) for b in range(B)]
    hi = [tokens_to_list(ti[b], si[b], eos) for b in range(B)]
    best_f, best_i = sf.max(1).values, si.max(1).values
    rel = ((best_i - best_f).abs() / best_f.abs()).max().item()
    same = sum(a == b for a, b in zip(hf, hi))
    assert rel <= INCR_SCORE_REL, (rel, best_f, best_i)
    log(f"[incremental] phase 5's model, {B} utterances, beam {E2E_BEAM['beam_size']}, RNNLM, "
        f"max_len {INCR_MAX_LEN} ({steps} steps run): token-identical {same} of {B}; best "
        f"score rel err {rel:.3e} (limit {INCR_SCORE_REL}); full-prefix eager {t_full * 1e3:.1f} "
        f"ms = {t_full / steps * 1e3:.2f} ms/step, KV-cached graph {t_inc * 1e3:.1f} ms = "
        f"{t_inc / steps * 1e3:.2f} ms/step; phase 11 (c) took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 12


def _float_leaves(tree):
    """The dtypes of the floating-point leaves of a nested dict."""
    if isinstance(tree, dict):
        return set().union(*(_float_leaves(v) for v in tree.values())) if tree else set()
    a = np.asarray(tree)
    return {a.dtype} if a.dtype.kind == "f" else set()


def _scale_rel(got, want):
    """max|got - want| over max|want| (float32 copies on the host)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def bf16_phase(e2e, x, lens, fdlp_cfg, fa, na, rng, dev, tmp):
    """bf16 mixed precision at wsj_fdlp_e2e on phase 5's weights and phase
    3's batch: recognize_batch in bf16 (FDLP on K1, counted) against the
    float32 chain in the same call; bf16 on the card against bf16 on the
    CPU; train_e2e.main --compute_dtype bfloat16 on phase 7's egs, with a
    step timed against a float32 step on the same batch; the conformer
    encoder in bf16; BF16_STREAMS streams through a StreamBatcher at
    attn_chunk 16 / left 4 against the offline bf16 chunked encode.
    Returns (K1's launches over the bf16 recognize_batch call, the CMVN'd
    features and their frame counts)."""
    import dataclasses
    import os

    from speech_recognition_tools_tpu_torch.cli import train_e2e
    from speech_recognition_tools_tpu_torch.decode.beam_jit import tokens_to_list
    from speech_recognition_tools_tpu_torch.infer.recognize import recognize_batch
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import StreamBatcher
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax
    from speech_recognition_tools_tpu_torch.io.text import (
        decode_tokens,
        read_text_file,
        save_vocab,
    )
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
        noam_schedule,
    )
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam
    from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn, cmvn_stats_masked

    t_phase = time.perf_counter()
    asr, lm, vocab = e2e["asr"], e2e["lm"], e2e["vocab"]
    idim, eos, B = fdlp_cfg.nfilters, asr.cfg.eos_id, len(lens)
    weights = asr.state_dict()

    def twin(device, **extra):
        m = TransformerASR(dataclasses.replace(asr.cfg, **extra), idim, device=device)
        m.load_state_dict(weights)
        return m.eval()

    asr16 = twin(dev, compute_dtype="bfloat16")
    mean, std = cmvn_stats_masked(fa, na)
    feats, nfr = apply_cmvn(fa, mean, std), na

    # the main path in bf16, counted, through the entry point a user calls
    lpc_cepstra.launches = 0
    K2.reset()
    GRAPHS.reset()
    texts16 = recognize_batch(x, lens, fdlp_cfg, mean, std, asr16, vocab, lm=lm, **E2E_BEAM,
                              max_len=BF16_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    launches = lpc_cepstra.launches
    assert launches > 0, "the bf16 e2e path did not launch K1"
    K2.read("bf16_e2e")
    GRAPHS.read("bf16_e2e")

    def encode(m, f=feats, n=nfr):
        with torch.no_grad():
            return m.encode(f, n)

    def search(m, mem, n, ctc, fused=lm, max_len=BF16_MAX_LEN, incremental=False):
        with torch.no_grad():
            return beam_search_encoded(m, mem, n, ctc, lm=fused, max_len=max_len,
                                       incremental=incremental, **E2E_BEAM)

    t_enc32, (m32, l32, c32) = wall_s(lambda: encode(asr))
    t_enc16, (m16, l16, c16) = wall_s(lambda: encode(asr16))
    assert m16.dtype == torch.bfloat16 and c16.dtype == torch.float32 and torch.equal(l16, l32)
    assert torch.isfinite(valid_rows(c16, l16)).all() and torch.isfinite(
        valid_rows(m16.float(), l16)).all()
    ctc_rel = _scale_rel(valid_rows(c16, l16), valid_rows(c32, l32))
    logp_err = (valid_rows(torch.log_softmax(c16, -1), l16)
                - valid_rows(torch.log_softmax(c32, -1), l32)).abs().max().item()
    assert ctc_rel <= BF16_VS_F32_REL, ctc_rel
    t_s32, (tk32, sc32) = _synced(lambda: search(asr, m32, l32, c32))
    t_s16, (tk16, sc16) = _synced(lambda: search(asr16, m16, l16, c16))
    assert sc16.dtype == torch.float32 and torch.isfinite(sc16).all(), sc16
    n32, n16 = (int((t[0, 0] >= 0).sum()) - 1 for t in (tk32, tk16))
    hyp32 = [tokens_to_list(tk32[b], sc32[b], eos) for b in range(B)]
    hyp16 = [tokens_to_list(tk16[b], sc16[b], eos) for b in range(B)]
    assert texts16 == [decode_tokens(h, vocab) for h in hyp16], "recognize_batch != its parts"
    same = sum(a == b for a, b in zip(hyp16, hyp32))
    log(f"[bf16] wsj_fdlp_e2e {B} utterances, phase 5's weights: recognize_batch in bf16, K1 "
        f"launches {launches}; encoder {t_enc16 * 1e3:.2f} ms bf16 / {t_enc32 * 1e3:.2f} ms "
        f"f32 a batch; beam search {t_s16 / n16 * 1e3:.2f} ms/step bf16 ({n16} steps) / "
        f"{t_s32 / n32 * 1e3:.2f} ms/step f32 ({n32} steps); bf16 vs f32 CTC logits "
        f"{ctc_rel:.3e} of their scale (limit {BF16_VS_F32_REL}), max|CTC logp diff| "
        f"{logp_err:.3e}; hypotheses token-identical to f32 {same} of {B}")

    # bf16 on the card against bf16 on the CPU, from the same features; the
    # KV-cached search of each from the card's encoder output
    k = BF16_CPU_UTTS
    cpu16 = twin("cpu", compute_dtype="bfloat16")
    cpu_lm = RNNLM(len(vocab), lm.embed.embedding_dim, lm.hidden, lm.layers, lm.cell,
                   device="cpu")
    cpu_lm.load_state_dict(lm.state_dict())
    nk = nfr[:k].cpu()
    fk = feats[:k, : int(nk.max())]
    mg, lg, cg = encode(asr16, fk, nfr[:k])
    mc, lc, cc = encode(cpu16, fk.cpu(), nk)
    assert torch.equal(lg.cpu(), lc)
    mem_dev = _scale_rel(valid_rows(mg.float().cpu(), lc), valid_rows(mc.float(), lc))
    ctc_dev = _scale_rel(valid_rows(cg.cpu(), lc), valid_rows(cc, lc))
    assert max(mem_dev, ctc_dev) <= BF16_DEVICE_REL, (mem_dev, ctc_dev)
    tg, sg = search(asr16, mg, lg, cg, max_len=BF16_CPU_MAX_LEN, incremental=True)
    tc, scc = search(cpu16, mg.cpu(), lc, cg.cpu(), fused=cpu_lm.eval(),
                     max_len=BF16_CPU_MAX_LEN, incremental=True)
    best_rel = ((sg.max(1).values.cpu() - scc.max(1).values).abs()
                / scc.max(1).values.abs()).max().item()
    assert best_rel <= BF16_DEVICE_REL, best_rel
    same_dev = sum(tokens_to_list(tg[b], sg[b], eos) == tokens_to_list(tc[b], scc[b], eos)
                   for b in range(k))
    log(f"[bf16] card vs cpu, both bf16, {k} utterances: encoder memory {mem_dev:.3e}, CTC "
        f"logits {ctc_dev:.3e} of their scale (limit {BF16_DEVICE_REL}); KV-cached search "
        f"(bf16 cache) from the card's memory, max_len {BF16_CPU_MAX_LEN}: best scores rel "
        f"{best_rel:.3e}, token-identical {same_dev} of {k}")

    # train_e2e.main in bf16 on phase 7's egs: float32 checkpoints
    egs7, text7 = os.path.join(tmp, "e2e_egs"), os.path.join(tmp, "e2e_text")
    store, vocab_path = os.path.join(tmp, "e2e_bf16"), os.path.join(tmp, "e2e_bf16_vocab.json")
    save_vocab(vocab, vocab_path)
    E = dict(E2E_TRAIN, epochs=1, average_last=1)
    argv = [egs7, text7, store, "--device", str(dev), "--compute_dtype", "bfloat16",
            "--vocab", vocab_path]
    argv += [a for kk, v in {**E2E_AM, **E}.items() if kk != "vocab_size"
             for a in (f"--{kk}", str(v))]
    t_main, losses = _synced(lambda: train_e2e.main(argv))
    assert len(losses) == 1 and np.isfinite(losses[0]), losses
    payload, meta = load_checkpoint(os.path.join(store, "epoch_1"))
    assert meta["compute_dtype"] == "bfloat16"
    assert _float_leaves(payload["params"]) == {np.dtype(np.float32)}
    assert _float_leaves(payload["opt_state"]) == {np.dtype(np.float32)}
    back = TransformerASR(asr16.cfg, idim, device=dev)
    back.load_state_dict(transformer_asr_from_jax(payload["params"]))

    # a step in bf16 against a step in float32, same batch and init
    texts7 = read_text_file(text7)
    batch = next(train_e2e.token_batches(egs7, texts7, vocab, E["batch_size"]))
    batch = {kk: torch.as_tensor(v, device=dev) for kk, v in batch.items()}
    step_ms, peak = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg = TransformerASRConfig(**E2E_AM, dropout=E["dropout"], mtlalpha=E["mtlalpha"],
                                   lsm_weight=E["lsm_weight"], compute_dtype=dt)
        m = TransformerASR(cfg, idim, device=dev)
        m.reset_parameters(torch.Generator().manual_seed(13))
        opt = ClipAdam(noam_schedule(cfg.adim, E["warmup_steps"], E["transformer_lr"]),
                       E["grad_clip"], b2=0.98)
        params = dict(m.named_parameters())
        state = {"opt": opt.init(params)}
        step = train_e2e.make_train_step(m, cfg, opt)

        def one():
            state["opt"], loss, _ = step(state["opt"], batch)
            return loss

        one()
        torch.cuda.reset_peak_memory_stats()
        t_step, loss = wall_s(one, repeats=BF16_TRAIN_STEPS)
        peak[dt] = torch.cuda.max_memory_allocated() / 2**30
        step_ms[dt] = t_step * 1e3
        assert torch.isfinite(loss) and loss.dtype == torch.float32
        assert {p.dtype for p in params.values()} == {p.grad.dtype for p in params.values()} \
            == {torch.float32}
        assert {v.dtype for mom in ("mu", "nu") for v in state["opt"][mom].values()} == {
            torch.float32}
        del m, opt, params, state, step
    log(f"[bf16-train] train_e2e.main --compute_dtype bfloat16 on phase 7's egs, 1 epoch of "
        f"2 batches of {E['batch_size']}: {t_main:.2f} s, loss {losses[0]:.4f}; checkpoint "
        f"params and Adam state float32; a step on the same batch: bf16 "
        f"{step_ms['bfloat16']:.1f} ms / f32 {step_ms['float32']:.1f} ms, peak memory "
        f"{peak['bfloat16']:.2f} / {peak['float32']:.2f} GiB")

    # the conformer (phase 10 (b)'s configuration, seeded weights) in bf16
    ccfg = TransformerASRConfig(**CONF_AM)
    cparams = transformer_asr_from_jax(random_asr_params(rng, ccfg, idim))
    confs = {}
    for dt in ("float32", "bfloat16"):
        m = TransformerASR(dataclasses.replace(ccfg, compute_dtype=dt), idim, device=dev)
        m.load_state_dict(cparams)
        confs[dt] = wall_s(lambda m=m.eval(): encode(m))
    (t_c32, (_, cl32, cc32)), (t_c16, (cm16, cl16, cc16)) = confs["float32"], confs["bfloat16"]
    assert cm16.dtype == torch.bfloat16 and torch.isfinite(valid_rows(cc16, cl16)).all()
    conf_rel = _scale_rel(valid_rows(cc16, cl16), valid_rows(cc32, cl32))
    assert conf_rel <= BF16_VS_F32_REL, conf_rel
    log(f"[bf16-conformer] wsj_fdlp_conformer_e2e encoder on {B} utterances: {t_c16 * 1e3:.2f} "
        f"ms bf16 / {t_c32 * 1e3:.2f} ms f32 a batch; CTC logits bf16 vs f32 {conf_rel:.3e} "
        f"of their scale (limit {BF16_VS_F32_REL})")

    # BF16_STREAMS streams through one StreamBatcher in bf16
    s16 = twin(dev, compute_dtype="bfloat16", **SERVE_CHUNK)
    sb = StreamBatcher(s16, max_streams=BF16_STREAMS, store_memory=True)
    assert {c["kv"].dtype for c in sb.caches.values()} == {torch.bfloat16}
    fb = [feats[b, : int(nfr[b])].cpu().numpy() for b in range(BF16_STREAMS)]
    sids = [sb.open() for _ in fb]
    t_rounds = time.perf_counter()
    for off in range(0, max(len(f) for f in fb), 25):
        for sid, f in zip(sids, fb):
            if off < len(f):
                sb.push(sid, f[off : off + 25])
    hyps = [sb.finish(sid) for sid in sids]
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t_rounds
    stream_rel = 0.0
    for sid, f in zip(sids, fb):
        m, n, _ = encode(s16, torch.as_tensor(f[None], device=dev),
                         torch.tensor([len(f)], device=dev))
        got = torch.as_tensor(sb.state(sid).memory)
        assert got.shape == (int(n[0]), s16.cfg.adim)
        stream_rel = max(stream_rel, _scale_rel(got, m[0, : int(n[0])]))
    assert stream_rel <= BF16_STREAM_REL, stream_rel
    log(f"[bf16-stream] attn_chunk {s16.cfg.attn_chunk} left {s16.cfg.attn_left_chunks}, "
        f"{BF16_STREAMS} streams in one bf16 StreamBatcher: {sb.rounds} rounds in "
        f"{t_rounds:.2f} s; streamed vs offline bf16 chunked memory {stream_rel:.3e} of its "
        f"scale (limit {BF16_STREAM_REL}); hypothesis lengths {[len(h) for h in hyps]}; "
        f"phase 12 (a) took {time.perf_counter() - t_phase:.1f} s")
    return launches, feats, nfr


def lstm_lm_phase(e2e, idim, dev, tmp):
    """Phase 9's LM stage with the lstm cell: train_lm.main --cell lstm at
    wsj_fdlp_e2e's LM width on phase 9's transcripts; one step card against
    CPU; a step's ms and tokens/s; phase 5's search fused with the trained
    LSTM LM on the card and on the CPU, token for token."""
    import dataclasses
    import os

    from speech_recognition_tools_tpu_torch.cli import train_lm
    from speech_recognition_tools_tpu_torch.cli.recog_e2e import _load_lm
    from speech_recognition_tools_tpu_torch.decode.beam_jit import tokens_to_list
    from speech_recognition_tools_tpu_torch.io.text import load_vocab, read_text_file
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.models.transformer_asr import TransformerASR
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

    t_phase = time.perf_counter()
    L = LM_TRAIN
    text, vocab_path, store = (os.path.join(tmp, d) for d in ("lm_text", "lm_vocab.json",
                                                               "lm_lstm"))
    argv = [text, store, "--vocab", vocab_path, "--device", str(dev), "--cell", "lstm"]
    argv += [a for k, v in L.items() for a in (f"--{k}", str(v))]
    t_main, nll = _synced(lambda: train_lm.main(argv))
    assert len(nll) == L["epochs"] and all(np.isfinite(nll)), nll
    assert load_checkpoint(os.path.join(store, "final"))[1]["cell"] == "lstm"
    vocab = load_vocab(vocab_path)
    V = len(vocab)
    batches = list(train_lm.lm_batches(read_text_file(text), vocab, L["batch_size"],
                                       L["bptt_len"], seed=0))

    def fresh(device):
        m = RNNLM(V, L["embed_dim"], L["hidden"], L["layers"], "lstm", device=device)
        m.reset_parameters(torch.Generator().manual_seed(7))
        opt = ClipAdam(L["learning_rate"], None, inject=False)
        return m, opt, train_lm.make_train_step(m, opt)

    def on(device, toks, lens):
        return (torch.as_tensor(toks, device=device).long(),
                torch.as_tensor(lens, device=device).long())

    toks, lens = batches[0][0][:LM_STEP_CPU_SEQS], batches[0][1][:LM_STEP_CPU_SEQS]
    toks = toks[:, : int(lens.max())]
    first = {}
    for device in ("cpu", dev):
        m, opt, step = fresh(device)
        _, loss = step(opt.init(dict(m.named_parameters())), *on(device, toks, lens))
        first[str(device)] = loss.item()
    l_c, l_g = first["cpu"], first[str(dev)]
    assert _rel(l_g, l_c) <= 1e-5, (l_g, l_c)
    m, opt, step = fresh(dev)
    state = {"opt": opt.init(dict(m.named_parameters()))}
    full = on(dev, *batches[0])

    def one():
        state["opt"], loss = step(state["opt"], *full)
        return loss

    one()
    t_step, _ = wall_s(one)
    n_tok = int((full[1] - 1).sum())

    # phase 5's search fused with the trained LSTM LM, card against CPU
    k = LSTM_SEARCH_UTTS
    lm, cpu_lm = _load_lm(store, device=dev), _load_lm(store, device="cpu")
    assert lm.cell == cpu_lm.cell == "lstm"
    asr = e2e["asr"]
    cpu_asr = TransformerASR(dataclasses.replace(asr.cfg), idim, device="cpu")
    cpu_asr.load_state_dict(asr.state_dict())
    mem, n, ctc = e2e["mem"][:k], e2e["enc_len"][:k], e2e["ctc"][:k]
    with torch.no_grad():
        tg, sg = beam_search_encoded(asr, mem, n, ctc, lm=lm, max_len=LM_SEARCH_MAX_LEN,
                                     **E2E_BEAM)
        tc, sc = beam_search_encoded(cpu_asr.eval(), mem.cpu(), n.cpu(), ctc.cpu(), lm=cpu_lm,
                                     max_len=LM_SEARCH_MAX_LEN, **E2E_BEAM)
    eos = asr.cfg.eos_id
    same = sum(tokens_to_list(tg[b], sg[b], eos) == tokens_to_list(tc[b], sc[b], eos)
               for b in range(k))
    best_rel = ((sg.max(1).values.cpu() - sc.max(1).values).abs()
                / sc.max(1).values.abs()).max().item()
    assert same == k and best_rel <= 1e-4, (same, best_rel)
    log(f"[lstm-lm] train_lm.main --cell lstm {L['layers']} x {L['hidden']}, embed "
        f"{L['embed_dim']}, vocab {V}, {len(batches)} batches of {L['batch_size']} (bptt_len "
        f"{L['bptt_len']}): {t_main:.2f} s, nll {nll[0]:.4f}; first step loss card "
        f"{l_g:.6f} / cpu {l_c:.6f} (rel {_rel(l_g, l_c):.3e}, limit 1e-5); a step on "
        f"B={len(batches[0][1])} x U={batches[0][0].shape[1]}: {t_step * 1e3:.1f} ms = "
        f"{n_tok / t_step:.0f} tokens/s")
    log(f"[lstm-lm] phase 5's search fused with it, beam 10, max_len {LM_SEARCH_MAX_LEN}, "
        f"{k} utterances: card vs cpu token-identical {same} of {k}, best scores rel "
        f"{best_rel:.3e} (limit 1e-4); phase 12 (b) took {time.perf_counter() - t_phase:.1f} s")


class _EspMHA(torch.nn.Module):
    """ESPnet's MultiHeadedAttention (linear_q/k/v/out), reconstructed."""

    def __init__(self, heads, adim):
        super().__init__()
        self.h, self.dk = heads, adim // heads
        for n in ("q", "k", "v", "out"):
            setattr(self, f"linear_{n}", torch.nn.Linear(adim, adim))

    def forward(self, q, k, v, mask=None):
        B = q.shape[0]

        def split(lin, t):
            return lin(t).view(B, -1, self.h, self.dk).transpose(1, 2)

        scores = split(self.linear_q, q) @ split(self.linear_k, k).transpose(-2, -1)
        scores = scores / float(np.sqrt(self.dk))
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        out = torch.softmax(scores, -1) @ split(self.linear_v, v)
        return self.linear_out(out.transpose(1, 2).reshape(B, -1, self.h * self.dk))


class _EspFF(torch.nn.Module):
    def __init__(self, adim, units):
        super().__init__()
        self.w_1, self.w_2 = torch.nn.Linear(adim, units), torch.nn.Linear(units, adim)

    def forward(self, x):
        return self.w_2(torch.relu(self.w_1(x)))


class _EspLayer(torch.nn.Module):
    """A pre-norm ESPnet encoder layer (self-attention, FFN) or decoder
    layer (self-attention, source attention, FFN); LayerNorm eps 1e-12."""

    def __init__(self, heads, adim, units, cross):
        super().__init__()
        self.self_attn = _EspMHA(heads, adim)
        if cross:
            self.src_attn = _EspMHA(heads, adim)
        self.feed_forward = _EspFF(adim, units)
        for i in range(3 if cross else 2):
            setattr(self, f"norm{i + 1}", torch.nn.LayerNorm(adim, eps=1e-12))
        self.cross = cross

    def forward(self, x, mem=None, mask=None):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, mask)
        if self.cross:
            h = self.norm2(x)
            x = x + self.src_attn(h, mem, mem)
        return x + self.feed_forward((self.norm3 if self.cross else self.norm2)(x))


class _EspnetE2E(torch.nn.Module):
    """A reconstruction of ESPnet's e2e_asr_transformer E2E (conv2d input
    layer, pre-norm blocks, sinusoidal positions scaled by sqrt(adim), CTC
    and attention heads) with ESPnet's state_dict key names."""

    def __init__(self, idim, odim, adim, heads, eunits, dunits, elayers, dlayers):
        super().__init__()
        nn = torch.nn
        self.adim = adim
        self.encoder, self.decoder, self.ctc = nn.Module(), nn.Module(), nn.Module()
        e, d = self.encoder, self.decoder
        e.embed = nn.Module()
        e.embed.conv = nn.Sequential(nn.Conv2d(1, adim, 3, 2), nn.ReLU(),
                                     nn.Conv2d(adim, adim, 3, 2), nn.ReLU())
        e.embed.out = nn.Sequential(nn.Linear(adim * (((idim - 1) // 2 - 1) // 2), adim))
        e.encoders = nn.ModuleList(_EspLayer(heads, adim, eunits, False)
                                   for _ in range(elayers))
        e.after_norm = nn.LayerNorm(adim, eps=1e-12)
        d.embed = nn.Sequential(nn.Embedding(odim, adim))
        d.decoders = nn.ModuleList(_EspLayer(heads, adim, dunits, True) for _ in range(dlayers))
        d.after_norm = nn.LayerNorm(adim, eps=1e-12)
        d.output_layer = nn.Linear(adim, odim)
        self.ctc.ctc_lo = nn.Linear(adim, odim)

    def _pe(self, n, device):
        from speech_recognition_tools_tpu_torch.models.transformer_asr import posenc_host

        return torch.as_tensor(posenc_host(n, self.adim), device=device)[None]

    def encode(self, x):
        e = self.encoder
        h = e.embed.conv(x[:, None])
        b, c, t, f = h.shape
        h = e.embed.out(h.transpose(1, 2).reshape(b, t, c * f))
        h = h * float(np.sqrt(self.adim)) + self._pe(t, x.device)
        for layer in e.encoders:
            h = layer(h)
        return e.after_norm(h)

    def decode(self, tokens, mem):
        d = self.decoder
        U = tokens.shape[1]
        h = d.embed(tokens) * float(np.sqrt(self.adim)) + self._pe(U, tokens.device)
        causal = torch.ones(U, U, dtype=torch.bool, device=tokens.device).tril()[None, None]
        for layer in d.decoders:
            h = layer(h, mem, causal)
        return d.output_layer(d.after_norm(h))


class _EspnetLM(torch.nn.Module):
    """ESPnet's DefaultRNNLM under ClassifierWithState ('predictor.'): embed
    -> LSTMCells -> Linear lo, reconstructed."""

    def __init__(self, vocab, embed, units, layers):
        super().__init__()
        p = self.predictor = torch.nn.Module()
        p.embed = torch.nn.Embedding(vocab, embed)
        p.rnn = torch.nn.ModuleList(torch.nn.LSTMCell(embed if i == 0 else units, units)
                                    for i in range(layers))
        p.lo = torch.nn.Linear(units, vocab)

    def forward(self, tokens):
        p = self.predictor
        B, U = tokens.shape
        hc = [(tokens.new_zeros((B, c.hidden_size), dtype=torch.float32),) * 2 for c in p.rnn]
        emb, outs = p.embed(tokens), []
        for t in range(U):
            h = emb[:, t]
            for i, cell in enumerate(p.rnn):
                hc[i] = cell(h, hc[i])
                h = hc[i][0]
            outs.append(p.lo(h))
        return torch.stack(outs, 1)


class _NnetRNN(torch.nn.Module):
    """The reference's nnetRNN (nnet_models.py:54), reconstructed: one
    nn.GRU per layer over packed sequences, then a 1x1 Conv1d regression."""

    def __init__(self, idim, layers, hidden, classes):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            torch.nn.GRU(idim if i == 0 else hidden, hidden, batch_first=True)
            for i in range(layers))
        self.regression = torch.nn.Conv1d(hidden, classes, 1)

    def forward(self, x, lengths):
        from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

        for gru in self.layers:
            packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                          enforce_sorted=False)
            x, _ = pad_packed_sequence(gru(packed)[0], batch_first=True,
                                       total_length=x.shape[1])
        return self.regression(x.transpose(1, 2)).transpose(1, 2)


def import_phase(feats, nfr, hyb_idim, dev, tmp, seed):
    """Reference checkpoints built here in their toolkits' layouts and
    torch.save'd: an ESPnet e2e transformer at wsj_fdlp_e2e's widths with
    its units file, an ESPnet DefaultRNNLM (1 x 1000 LSTM), a reference
    nnetRNN .model dict at timit_hybrid's widths. import_torch_ckpt.main
    imports each; recog_e2e.main decodes phase 7's egs (phase 3's K1
    features) with the imported model and LM fused; dump_outputs.main runs
    the imported hybrid model over phase 6's egs. Each imported model is
    held to its torch reconstruction's forward on the card."""
    import os
    import string

    from speech_recognition_tools_tpu_torch.cli import dump_outputs, import_torch_ckpt, recog_e2e
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    A, V, idim = E2E_AM, E2E_AM["vocab_size"], feats.shape[-1]
    torch.manual_seed(seed)
    esp = _EspnetE2E(idim, V, A["adim"], A["aheads"], A["eunits"], A["dunits"], A["elayers"],
                     A["dlayers"]).eval()
    esp_lm = _EspnetLM(V, LM_TRAIN["embed_dim"], LM_TRAIN["hidden"], 1).eval()
    hyb = _NnetRNN(hyb_idim, HYBRID_TRAIN["num_layers"], HYBRID_TRAIN["hidden_dim"],
                   HYBRID_CLASSES).eval()
    units = ["<unk>", "<space>"] + list(string.ascii_letters[: V - 4])
    with open(j("esp_units.txt"), "w") as fh:  # ids 1..V-2; 0 = blank, V-1 = sos/eos
        fh.writelines(f"{u} {i + 1}\n" for i, u in enumerate(units))
    torch.save(esp.state_dict(), j("model.acc.best"))
    torch.save(esp_lm.state_dict(), j("rnnlm.model.best"))
    torch.save({"model_state_dict": hyb.state_dict(), "dropout": 0.0, "epoch": 1},
               j("hybrid.model"))
    t_imp, _ = _synced(lambda: (
        import_torch_ckpt.main([j("model.acc.best"), j("esp_am"), "--espnet_units",
                                j("esp_units.txt"), "--aheads", str(A["aheads"])]),
        import_torch_ckpt.main([j("rnnlm.model.best"), j("esp_lm")]),
        import_torch_ckpt.main([j("hybrid.model"), j("imp_hyb")])))

    # recog_e2e over phase 7's egs with the imported model and LM
    t_rec, hyps = _synced(lambda: recog_e2e.main([
        j("esp_am"), j("e2e_egs"), j("esp_hyp.txt"), "--lm_dir", j("esp_lm"), "--jit_decode",
        "--batch_size", "32", "--max_len", str(IMPORT_RECOG_MAX_LEN), "--device", str(dev)]))
    assert len(hyps) == 2 * len(nfr) and all(isinstance(h, str) for h in hyps.values())

    # each imported model against its torch reconstruction on the card
    model, cfg, _ = recog_e2e._load(j("esp_am"), "final_avg", device=dev)
    lm = recog_e2e._load_lm(j("esp_lm"), device=dev)
    assert (cfg.elayers, cfg.dlayers, cfg.adim, lm.cell) == (A["elayers"], A["dlayers"],
                                                              A["adim"], "lstm")
    esp, esp_lm, hyb = esp.to(dev), esp_lm.to(dev), hyb.to(dev)
    gen = torch.Generator().manual_seed(seed)
    e2e_err = 0.0
    for b in range(IMPORT_UTTS):
        f = feats[b : b + 1, : int(nfr[b])]
        tokens = torch.randint(0, V, (1, 20), generator=gen).to(dev)
        with torch.no_grad():
            mem_t = esp.encode(f)
            want = (mem_t, esp.ctc.ctc_lo(mem_t), esp.decode(tokens, mem_t))
            mem, n, ctc = model.encode(f, nfr[b : b + 1])
            got = (mem, ctc, model.decode_step(tokens, mem, n))
        assert int(n[0]) == mem_t.shape[1]
        e2e_err = max(e2e_err, *((g - w).abs().max().item() for g, w in zip(got, want)))
    assert e2e_err <= IMPORT_E2E_ATOL, e2e_err
    tokens = torch.randint(0, V, (4, 30), generator=gen).to(dev)
    with torch.no_grad():
        lm_err = (lm(tokens) - esp_lm(tokens)).abs().max().item()
    assert lm_err <= IMPORT_LM_ATOL, lm_err

    # dump_outputs of the imported hybrid model against the reconstruction
    t_dump, _ = _synced(lambda: dump_outputs.main([j("imp_hyb"), j("hyb_egs"), j("imp_ll"),
                                                   "--device", str(dev)]))
    dumped = dict(read_ark(j("imp_ll.ark")))
    b0 = next(iter_egs_batches(j("hyb_egs"), 4))
    with torch.no_grad():
        ref = hyb(torch.as_tensor(b0["feats"], device=dev),
                  torch.as_tensor(b0["lengths"], device=dev)).cpu().numpy()
    hyb_err = max(float(np.abs(dumped[key] - ref[i, : int(b0["lengths"][i])]).max())
                  for i, key in enumerate(b0["keys"]))
    assert hyb_err <= IMPORT_HYB_ATOL, hyb_err
    log(f"[import] ESPnet e2e ({A['elayers']}/{A['dlayers']} layers, adim {A['adim']}), "
        f"DefaultRNNLM 1 x {LM_TRAIN['hidden']} LSTM, nnetRNN {HYBRID_TRAIN['num_layers']} x "
        f"{HYBRID_TRAIN['hidden_dim']} -> {HYBRID_CLASSES}: imported in {t_imp:.2f} s; "
        f"recog_e2e --lm_dir (imported LSTM) --jit_decode over {len(hyps)} utterances, "
        f"max_len {IMPORT_RECOG_MAX_LEN}: {t_rec:.2f} s; dump_outputs over phase 6's egs: "
        f"{t_dump:.2f} s")
    log(f"[import] imported vs torch reconstruction on the card: e2e encoder/CTC/decoder "
        f"max|err| {e2e_err:.3e} (atol {IMPORT_E2E_ATOL}), LM logits {lm_err:.3e} (atol "
        f"{IMPORT_LM_ATOL}), hybrid logits {hyb_err:.3e} (atol {IMPORT_HYB_ATOL}); phase 12 "
        f"(c) took {time.perf_counter() - t_phase:.1f} s")


class _StepTimes:
    """Times every Trainer.train_step (synchronised) while active, so that
    train_am.main's own steps give ms a step."""

    def __enter__(self):
        from speech_recognition_tools_tpu_torch.train import trainer

        self.cls, self.orig, self.times = trainer.Trainer, trainer.Trainer.train_step, []
        orig, times = self.orig, self.times

        def timed(tr, state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(tr, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        self.cls.train_step = timed
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig


def _max_rel(got, want):
    """max |got - want| over the largest |want|, across dicts of arrays."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / max(scale, 1e-30)


def _argv(flags):
    return [a for k, v in flags.items() for a in (f"--{k}", str(v))]


def pm_stage_phase(rng, dev, tmp):
    """Phase 13 (a): the hybrid recipes' stage 6 at timit_hybrid on the card:
    FDLP featgen (K1) of PM_UTTS held-out utterances with phase 6's CMVN ->
    dump_outputs --prior of phase 6's AM (3 x 512 GRU, 3,376 classes) ->
    build_egs of the log-likelihoods -> train_am.main --arch pm_ae --loss
    mse at the pm block (2 + 2 x 512, bn 64) -> pm_score_cli pm
    (reconstruction, --contrastive) and pm_score_cli mmeasure on the AM's
    posteriors. K1 is counted over the path and then held to its plain
    version on the path's own lags; the PM scores on the card are held to
    the CPU's on the same checkpoints. Returns K1's launches."""
    import os
    import pickle

    from speech_recognition_tools_tpu_torch.cli import dump_outputs, pm_score_cli, train_am
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        fdlp_lags,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, load_egs
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )

    t_phase = time.perf_counter()
    hyb = FdlpConfig()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    xp, lp = speechlike_batch(rng, PM_UTTS, 1.0, 2.5)
    audio_s = float(lp.sum()) / hyb.srate
    t = {}

    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    feats, nfr = fdlp_spectrogram_batch(xp, lp, hyb, device=dev)
    cfg_egs, _ = load_egs(j("hyb_egs"))
    cmvn = (np.asarray(cfg_egs.cmvn_mean), np.asarray(cfg_egs.cmvn_std))
    keys = [f"pm{b:02d}" for b in range(PM_UTTS)]
    rows = [(k, feats[b, : int(nfr[b])].cpu().numpy()) for b, k in enumerate(keys)]
    build_egs(iter(rows), j("pm_feat_egs"), cmvn=cmvn)
    short = sorted(range(PM_UTTS), key=lambda b: int(nfr[b]))[:ZOO_CPU_UTTS]
    build_egs(iter(rows[b] for b in short), j("pm_feat_small"), cmvn=cmvn)
    t["featgen + egs"] = time.perf_counter() - t0
    t["dump_outputs"], _ = _synced(lambda: dump_outputs.main(
        [j("hyb_am"), j("pm_feat_egs"), j("pm_ll"), "--prior", j("prior.pkl"),
         "--device", str(dev)]))
    lls = dict(read_mat_scp(j("pm_ll.scp")))
    t0 = time.perf_counter()
    build_egs(((f"{k}_{c}", v) for c in range(2) for k, v in lls.items()), j("pm_egs"))
    build_egs(((k, lls[k]) for k in (keys[b] for b in short)), j("pm_small"))
    t["build_egs"] = time.perf_counter() - t0
    with _StepTimes() as steps:
        t["train_am pm_ae"], st = _synced(lambda: train_am.main(
            [j("pm_egs"), j("pm"), "--arch", "pm_ae", "--loss", "mse", *_argv(PM_TRAIN),
             "--device", str(dev)]))
    scores = {}
    for mode, flags in (("recon", []), ("contrastive", ["--contrastive"])):
        t[f"pm_score_cli pm {mode}"], scores[mode] = _synced(lambda: pm_score_cli.main(
            ["pm", j("hyb_am"), j("pm"), j("pm_feat_egs"), j(f"pm_{mode}.pkl"), *flags,
             "--device", str(dev)]))
    t["dump_outputs --add_softmax"], _ = _synced(lambda: dump_outputs.main(
        [j("hyb_am"), j("pm_feat_egs"), j("pm_post"), "--add_softmax", "--device", str(dev)]))
    t["pm_score_cli mmeasure"], mm = _synced(lambda: pm_score_cli.main(
        ["mmeasure", j("pm_post.scp"), j("pm_mm.pkl")]))
    torch.cuda.synchronize()
    launches = lpc_cepstra.launches
    assert launches > 0, "the PM stage's featgen did not launch K1"

    assert len(st.history) == 1 and np.isfinite(st.history[0]["train_loss"]), st.history
    assert len(steps.times) == 2, steps.times
    for mode in scores:
        assert sorted(scores[mode]) == keys and all(np.isfinite(v)
                                                    for v in scores[mode].values()), mode
        with open(j(f"pm_{mode}.pkl"), "rb") as f:
            assert pickle.load(f) == scores[mode]
    assert sorted(mm) == keys and all(np.isfinite(v) for v in mm.values())
    # the card's scores against the CPU's on the same checkpoints
    score_err = {}
    for mode, flags in (("recon", []), ("contrastive", ["--contrastive"])):
        got = {d: pm_score_cli.main(["pm", j("hyb_am"), j("pm"), j("pm_feat_small"),
                                     j(f"pm_small_{d}.pkl"), *flags, "--device", d])
               for d in (str(dev), "cpu")}
        score_err[mode] = _max_rel({k: np.float64(v) for k, v in got[str(dev)].items()},
                                   {k: np.float64(v) for k, v in got["cpu"].items()})
        assert score_err[mode] <= ZOO_OUT_REL, (mode, score_err[mode])
    # K1 on the path's own lags against its plain version
    r, _ = fdlp_lags(xp, lp, hyb, device=dev)
    r = r.reshape(-1, r.shape[-1])
    got = lpc_cepstra(r, hyb.order, hyb.coeff_num)
    ref = lpc_cepstra_reference(r, hyb.order, hyb.coeff_num)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _, k1_t, k1_rel = cep_agreement(f"PM-stage lags P={r.shape[0]}", got, ref)
    assert k1_t <= MAIN_PATH_TOL and k1_rel <= MAIN_PATH_REL, (k1_t, k1_rel)

    frames = int(nfr.sum())
    log(f"[pm-stage] timit_hybrid stage 6: {PM_UTTS} held-out utterances of 1-2.5 s "
        f"({audio_s:.1f} s audio, {frames} frames) -> phase 6's AM -> {HYBRID_CLASSES}-dim "
        f"log-likelihood egs (each twice) -> train_am --arch pm_ae --loss mse "
        f"{PM_TRAIN['num_layers']} + {PM_TRAIN['num_layers_dec']} x {PM_TRAIN['hidden_dim']}, "
        f"bn {PM_TRAIN['bn_dim']}, 1 epoch of 2 batches of {PM_TRAIN['batch_size']}: train "
        f"{st.history[0]['train_loss']:.4f} dev {st.history[0]['dev_loss']:.4f}; K1 launches "
        f"{launches}")
    log(f"[pm-stage] ms a PM step (synchronised): "
        + ", ".join(f"{s * 1e3:.1f}" for s in steps.times)
        + f"; scores per s: reconstruction {PM_UTTS / t['pm_score_cli pm recon']:.1f}, "
        f"contrastive {PM_UTTS / t['pm_score_cli pm contrastive']:.1f} (CLI wall, AM + PM "
        f"on the card); m-measure {PM_UTTS / t['pm_score_cli mmeasure']:.1f} per s (host)")
    log(f"[pm-stage] scores card vs cpu ({ZOO_CPU_UTTS} utterances): reconstruction "
        f"{score_err['recon']:.3e}, contrastive {score_err['contrastive']:.3e} of their scale "
        f"(limit {ZOO_OUT_REL}); sample scores {scores['recon'][keys[0]]:.4f} / "
        f"{scores['contrastive'][keys[0]]:.4f}, m-measure {mm[keys[0]]:.3e}")
    log("[pm-stage] wall s by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
        + f"; phase 13 (a) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def zoo_phase(dev, tmp):
    """Phase 13 (b): every other arch of the recurrent half through
    train_am.main on the card at its defaults (num_layers_dec 1, hidden
    512, bn 64, comp_num 2) but ZOO_B_LAYERS layer(s) (cut from 3) over phase
    6's timit_hybrid egs (20-dim FDLP, 3,376 classes; the first
    ZOO_MAX_FRAMES frames of each utterance, twice: one epoch of 2 batches
    of 32): vae also with --use_transformer (over phase 7's 80-band
    wsj_fdlp_e2e egs: flax's 16 heads need a width they divide; 64
    utterances of 6-10 s), multimod also with
    --multi_egs_dirs (a delta stream), feedforward also with --frame_egs
    (context 4, two batches of half the frames), vae_encoded and
    curl_encoded on the vae and curl just trained, curl --expand_from the
    curl just trained. Each: ms a step; on the weights the training starts
    from (train_am.main --epochs 0), the first-step loss card vs CPU with
    the same noise and dump_outputs card vs CPU. Then tandem_feats
    --get_pca on phase 6's AM."""
    import os

    from speech_recognition_tools_tpu_torch.cli import dump_outputs, tandem_feats, train_am
    from speech_recognition_tools_tpu_torch.io.egs import (
        build_egs,
        build_frame_egs,
        iter_egs_batches,
        iter_egs_batches_multi,
        iter_frame_batches,
        load_egs,
    )
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.utils.transforms import add_deltas

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    _, utts = load_egs(j("hyb_egs"))
    deltas = {k: add_deltas(torch.as_tensor(f), order=1)[:, f.shape[1]:].numpy()
              for k, f, _ in utts}
    twice = [(f"{k}_{c}", f, lab) for c in range(2) for k, f, lab in utts]
    labels = {k: lab for k, _, lab in twice}
    # whole utterances for phase 14 (a)'s conv archs, whose padded batches
    # it checks; the first ZOO_MAX_FRAMES frames for these archs
    build_egs(((k, f) for k, f, _ in twice), j("zoo_egs"), labels, num_targets=HYBRID_CLASSES)
    cut = ZOO_MAX_FRAMES
    build_egs(((k, f[:cut]) for k, f, _ in twice), j("zoo_cut_egs"),
              {k: lab[:cut] for k, lab in labels.items()}, num_targets=HYBRID_CLASSES)
    build_egs(((k, deltas[k[:-2]][:cut]) for k, _, _ in twice), j("zoo_delta_egs"),
              {k: lab[:cut] for k, lab in labels.items()}, num_targets=HYBRID_CLASSES)
    short = sorted(utts, key=lambda u: len(u[1]))[:ZOO_CPU_UTTS]
    build_egs(((k, f) for k, f, _ in short), j("zoo_small"), {k: v for k, _, v in short},
              num_targets=HYBRID_CLASSES)
    build_egs(((k, deltas[k]) for k, _, _ in short), j("zoo_small_delta"),
              {k: v for k, _, v in short}, num_targets=HYBRID_CLASSES)
    build_frame_egs(((k, f) for k, f, _ in utts), j("zoo_frame_egs"),
                    {k: v for k, _, v in utts}, num_targets=HYBRID_CLASSES)
    n_frames = sum(len(f) for _, f, _ in utts)
    # the transformer VAE over phase 7's wsj_fdlp_e2e egs (80 bands with
    # global CMVN): flax's 16 heads need an input width they divide, which
    # timit_hybrid's 20 bands are not
    _, e2e_utts = load_egs(j("e2e_egs"))
    build_egs(((k, f) for k, f, _ in sorted(e2e_utts, key=lambda u: len(u[1]))[:ZOO_CPU_UTTS]),
              j("e2e_small"))
    base = _argv(dict(ZOO_TRAIN, num_layers=ZOO_B_LAYERS))
    # name -> (train_am flags, egs, dump egs (+ flags) or None)
    cases = {
        "linear": (["--arch", "linear"], "zoo_cut_egs", ["zoo_small"]),
        "feedforward": (["--arch", "feedforward"], "zoo_cut_egs", ["zoo_small", "--layer", "1"]),
        "feedforward --frame_egs": (["--arch", "feedforward", "--frame_egs", "--batch_size",
                                     str(n_frames // 2)], "zoo_frame_egs", None),
        "multitask_ae": (["--arch", "multitask_ae"], "zoo_cut_egs", ["zoo_small"]),
        "multitask_aear": (["--arch", "multitask_aear"], "zoo_cut_egs", ["zoo_small"]),
        "multimod --multi_egs_dirs": (["--arch", "multimod", "--multi_egs_dirs",
                                       j("zoo_delta_egs")], "zoo_cut_egs",
                                      ["zoo_small", "--multi_egs_dirs", j("zoo_small_delta")]),
        "vae": (["--arch", "vae"], "zoo_cut_egs", ["zoo_small"]),
        "vae --use_transformer": (["--arch", "vae", "--use_transformer"], "e2e_egs",
                                  ["e2e_small"]),
        "vae_classifier": (["--arch", "vae_classifier"], "zoo_cut_egs", ["zoo_small"]),
        # the JAX dump_outputs indexes arvae's and curl_unsup's decoder axis
        # by utterance (ROADMAP Queue 3); the port does the same: no dump
        "arvae": (["--arch", "arvae"], "zoo_cut_egs", None),
        "vae_encoded": (["--arch", "vae_encoded", "--base_model", j("zoo_vae")], "zoo_cut_egs",
                        ["zoo_small"]),
        "apc": (["--arch", "apc"], "zoo_cut_egs", ["zoo_small"]),
        "curl": (["--arch", "curl"], "zoo_cut_egs", ["zoo_small"]),
        "curl --expand_from": (["--arch", "curl", "--expand_from", j("zoo_curl")], "zoo_cut_egs",
                               ["zoo_small"]),
        "curl_unsup": (["--arch", "curl_unsup"], "zoo_cut_egs", None),
        "curl_encoded": (["--arch", "curl_encoded", "--base_model", j("zoo_curl")], "zoo_cut_egs",
                         ["zoo_small"]),
    }
    rows = []
    for name, (flags, egs, dump) in cases.items():
        store = j("zoo_" + name.replace(" --", "_").replace(" ", "_"))
        argv = [j(egs), store, *base, *flags]
        # the weights the training starts from (train_am draws them on the
        # CPU from --seed): the card-vs-CPU checks run on them
        init = store + "_init"
        train_am.main([j(egs), init, *base, *flags, "--epochs", "0", "--device", str(dev)])
        with _StepTimes() as steps:
            t_main, st = _synced(lambda: train_am.main([*argv, "--device", str(dev)]))
        assert len(st.history) == 1 and all(np.isfinite(v) for v in (
            st.history[0]["train_loss"], st.history[0]["dev_loss"])), (name, st.history)
        assert len(steps.times) == 2, (name, steps.times)
        # the first-step loss on the card and on the CPU: the initial
        # weights, the ZOO_CPU_UTTS shortest utterances, the same noise
        args = train_am.get_parser().parse_args(argv)
        if args.frame_egs:
            small = next(iter_frame_batches(j(egs), 64))
        elif args.multi_egs_dirs:
            small = next(iter_egs_batches_multi([j("zoo_small"), j("zoo_small_delta")], 4))
        else:
            small = next(iter_egs_batches(j(dump[0] if dump else "zoo_small"), ZOO_CPU_UTTS))
        # the transformer VAE's logvar reaches ~17 on these features at
        # init (no LayerNorm before its heads): its KL term exp(2 logvar)
        # and its sample exp(logvar) * eps amplify float32 rounding past the
        # limits, so its loss and its forward are compared in float64
        dtype = torch.float64 if args.use_transformer else torch.float32
        loss, fwd = {}, {}
        for d in (str(dev), "cpu"):
            model, _, cfg = dump_outputs.load_model_from_checkpoint(init, d)
            enc = None
            if args.base_model:
                enc, _ = dump_outputs.load_frozen_encoder(args.base_model, args.arch, d)
            fn = train_am.make_loss(args, enc, torch.Generator().manual_seed(11))
            batch = {k: (v.to(dtype) if v.is_floating_point() else v) if torch.is_tensor(v)
                     else [s.to(dtype) for s in v]
                     for k, v in train_am.batch_on_device(small, torch.device(d)).items()}
            with torch.no_grad():
                loss[d] = fn(model.to(dtype), batch, True)[0].item()
                if args.use_transformer:
                    fwd[d] = {"out": dump_outputs.arch_forward(
                        model, cfg, batch["feats"], batch["lengths"],
                        torch.Generator().manual_seed(2))[0].cpu().numpy()}
        loss_rel = _rel(loss[str(dev)], loss["cpu"])
        assert np.isfinite(loss["cpu"]) and loss_rel <= ZOO_LOSS_REL, (name, loss)
        out_rel = None
        if dump:
            arks = {}
            for d in (str(dev), "cpu")[: 1 if fwd else 2]:
                dump_outputs.main([init, j(dump[0]), j(f"zoo_out_{d}"), *dump[1:],
                                   "--device", d])
                arks[d] = dict(read_ark(j(f"zoo_out_{d}.ark")))
            assert all(np.isfinite(v).all() for v in arks[str(dev)].values()), name
            ref = fwd or arks
            out_rel = _max_rel(ref[str(dev)], ref["cpu"])
            assert out_rel <= ZOO_OUT_REL, (name, out_rel)
        rows.append((name, steps.times, t_main, st.history[0], loss[str(dev)], loss_rel,
                     out_rel))
    for name, times, t_main, h, l0, lrel, orel in rows:
        log(f"[zoo] {name:26s} ms a step {times[0] * 1e3:8.1f} / {times[1] * 1e3:8.1f} "
            f"(first / second); train_am.main {t_main:6.2f} s; train {h['train_loss']:.4f} dev "
            f"{h['dev_loss']:.4f}; first-step loss card {l0:.6f}, rel to cpu {lrel:.2e} (limit "
            f"{ZOO_LOSS_REL}); dump_outputs card vs cpu "
            + (f"{orel:.2e} of scale (limit {ZOO_OUT_REL})" if orel is not None else "not run")
            + (" (loss and forward in float64; the dump on the card only)"
               if "use_transformer" in name else ""))
    # tandem features (PCA) of phase 6's AM, card against CPU
    tand = {}
    for d in (str(dev), "cpu"):
        tandem_feats.main([j("hyb_am"), j("zoo_small"), j(f"tandem_{d}"), "--get_pca",
                           "--pca_dim", "40", "--device", d])
        tand[d] = dict(read_ark(j(f"tandem_{d}.ark")))
    pca = dict(read_ark(j(f"tandem_{dev}_pca.ark")))
    assert all(v.shape[1] == 40 and np.isfinite(v).all() for v in pca.values())
    tand_rel = _max_rel(tand[str(dev)], tand["cpu"])
    assert tand_rel <= ZOO_OUT_REL, tand_rel
    log(f"[zoo] tandem_feats --get_pca --pca_dim 40 on phase 6's AM: presoftmax card vs cpu "
        f"{tand_rel:.2e} of scale (limit {ZOO_OUT_REL}); {len(cases)} archs / flag sets; "
        f"phase 13 (b) took {time.perf_counter() - t_phase:.1f} s")


class _CldnnRef(torch.nn.Module):
    """The reference nnetCLDNN's parameter layout (nnet_models_cnn.py:32):
    `cnn_layers.{i}` Conv2d, `dim_reduce` a 1x1 Conv1d over the (C, H)
    flattened map, `lstm_layers.{i}` one-layer LSTMs, `dnn_layers.{i}`
    1x1 Conv1d; built here so that import_torch_ckpt has a checkpoint to
    import."""

    def __init__(self, idim, channels, hidden, lstm_layers, classes):
        super().__init__()
        self.cnn_layers = torch.nn.ModuleList([torch.nn.Conv2d(1, channels, 3, padding=1)])
        self.dim_reduce = torch.nn.Conv1d(idim * channels, hidden, 1)
        self.lstm_layers = torch.nn.ModuleList(
            torch.nn.LSTM(hidden, hidden, batch_first=True) for _ in range(lstm_layers))
        self.dnn_layers = torch.nn.ModuleList([torch.nn.Conv1d(hidden, hidden, 1),
                                               torch.nn.Conv1d(hidden, classes, 1)])


def conv_zoo_phase(dev, tmp, seed):
    """Phase 14 (a): the conv half of the zoo through train_am.main on the
    card at its defaults (ZOO_TRAIN: cnn and cldnn with hidden // 8 = 64
    channels, the conv VAEs with 32 / 64, 3 x 3 kernels, the modnets on
    21-frame patches with 10 candidate frequencies and 4 heads) over phase
    13's doubled timit_hybrid egs (one epoch of 2 batches of 32). Each: ms a
    step; on the weights the training starts from, the first-step loss
    card vs CPU with the same noise and dump_outputs card vs CPU on the
    ZOO_CPU_UTTS shortest utterances. Then a reference nnetCLDNN .model
    dict, imported by import_torch_ckpt, dumped card vs CPU."""
    import os

    from speech_recognition_tools_tpu_torch.cli import dump_outputs, import_torch_ckpt, train_am
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches, load_egs

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    base = _argv(ZOO_TRAIN)
    small = next(iter_egs_batches(j("zoo_small"), ZOO_CPU_UTTS))
    rows = []
    for arch in CONV_ARCHS:
        store = j(f"conv_{arch}")
        argv = [j("zoo_egs"), store, *base, "--arch", arch]
        train_am.main([*argv[:1], store + "_init", *argv[2:], "--epochs", "0", "--device",
                       str(dev)])
        with _StepTimes() as steps:
            t_main, st = _synced(lambda: train_am.main([*argv, "--device", str(dev)]))
        assert len(st.history) == 1 and len(steps.times) == 2, (arch, steps.times)
        h = st.history[0]
        finite = [np.isfinite(h[k]) for k in ("train_loss", "dev_loss")]
        if arch == "modnet_sigmoid":
            # the JAX fault both packages share: sqrt's 0 / 0 gradient on
            # the all-zero patches past an utterance's end
            assert not any(finite), (arch, h)
        elif arch in ("cnn", "cldnn", "modnet"):
            assert all(finite), (arch, h)
        # the conv VAEs may diverge under Adam at these widths, in both
        # packages (their KL holds exp(logvar) ** 2; ROADMAP Queue 3)
        args = train_am.get_parser().parse_args(argv)
        # the conv VAEs' KL holds exp(logvar) ** 2, which turns float32
        # rounding of a large logvar into more than ZOO_LOSS_REL: their
        # first-step loss is compared in float64, as phase 13's
        # transformer VAE's
        dtype = torch.float64 if "vae" in arch else torch.float32
        loss, dumps = {}, {}
        for d in (str(dev), "cpu"):
            model, _, _ = dump_outputs.load_model_from_checkpoint(store + "_init", d)
            fn = train_am.make_loss(args, None, torch.Generator().manual_seed(11))
            batch = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in train_am.batch_on_device(small, torch.device(d)).items()}
            with torch.no_grad():
                loss[d] = fn(model.to(dtype), batch, True)[0].item()
            dumps[d] = dump_outputs.main([store + "_init", j("zoo_small"), j(f"conv_out_{d}"),
                                          "--device", d])
        if arch == "rs_vae" and not np.isfinite(loss["cpu"]):
            # its KL overflows float64 on these features at init, on both
            # devices (ROADMAP Queue 3): hold the log-std head instead
            assert not np.isfinite(loss[str(dev)]), loss
            loss_rel, logvars = float("nan"), {}
            for d in (str(dev), "cpu"):
                model, _, _ = dump_outputs.load_model_from_checkpoint(store + "_init", d)
                x = train_am.image(torch.as_tensor(small["feats"], device=d, dtype=dtype))
                with torch.no_grad():
                    logvars[d] = {"lv": model.to(dtype)(x, eps=torch.zeros(1))[1][1].cpu().numpy()}
            lv_rel = _max_rel(logvars[str(dev)], logvars["cpu"])
            assert lv_rel <= ZOO_OUT_REL, lv_rel
            log(f"[conv] rs_vae first-step loss NaN on card and cpu (float64); its log-std head "
                f"reaches {np.abs(logvars['cpu']['lv']).max():.1f}, card vs cpu {lv_rel:.2e} of "
                f"scale (limit {ZOO_OUT_REL})")
        else:
            loss_rel = _rel(loss[str(dev)], loss["cpu"])
            assert np.isfinite(loss["cpu"]) and loss_rel <= ZOO_LOSS_REL, (arch, loss)
        assert all(np.isfinite(v).all() for v in dumps[str(dev)].values()), arch
        out_rel = _max_rel(dumps[str(dev)], dumps["cpu"])
        assert out_rel <= ZOO_OUT_REL, (arch, out_rel)
        width = next(iter(dumps["cpu"].values())).shape[1]
        rows.append((arch, steps.times, t_main, h, loss[str(dev)], loss_rel, out_rel, width,
                     dtype))
    for arch, times, t_main, h, l0, lrel, orel, width, dtype in rows:
        log(f"[conv] {arch:15s} ms a step {times[0] * 1e3:8.1f} / {times[1] * 1e3:8.1f} "
            f"(first / second); train_am.main {t_main:6.2f} s; train {h['train_loss']:.6g} dev "
            f"{h['dev_loss']:.6g}; first-step loss card {l0:.6g} ({str(dtype)[6:]}), rel to "
            f"cpu {lrel:.2e} (limit {ZOO_LOSS_REL}); dump_outputs ({width} per frame) card vs "
            f"cpu {orel:.2e} of scale (limit {ZOO_OUT_REL})")

    # a reference nnetCLDNN, imported, dumped card vs CPU
    cfg_egs, _ = load_egs(j("zoo_egs"))
    torch.manual_seed(seed)
    ref = _CldnnRef(cfg_egs.feat_dim, CLDNN_IMPORT["channels"], CLDNN_IMPORT["hidden"],
                    CLDNN_IMPORT["lstm_layers"], HYBRID_CLASSES)
    torch.save({"model_state_dict": ref.state_dict(), "dropout": 0.0, "epoch": 1},
               j("cldnn.model"))
    import_torch_ckpt.main([j("cldnn.model"), j("imp_cldnn")])
    t_dump, dumps = {}, {}
    for d in (str(dev), "cpu"):
        t_dump[d], dumps[d] = _synced(lambda: dump_outputs.main(
            [j("imp_cldnn"), j("zoo_small"), j(f"imp_cldnn_{d}"), "--device", d]))
    imp_rel = _max_rel(dumps[str(dev)], dumps["cpu"])
    assert all(np.isfinite(v).all() for v in dumps[str(dev)].values())
    assert imp_rel <= ZOO_OUT_REL, imp_rel
    log(f"[conv] imported nnetCLDNN ({CLDNN_IMPORT['channels']} channels, "
        f"{CLDNN_IMPORT['lstm_layers']} x {CLDNN_IMPORT['hidden']} LSTM, {HYBRID_CLASSES} "
        f"classes): dump_outputs card {t_dump[str(dev)]:.2f} s, card vs cpu {imp_rel:.2e} of "
        f"scale (limit {ZOO_OUT_REL}); phase 14 (a) took {time.perf_counter() - t_phase:.1f} s")


class _AdaptStepTimes:
    """Times every step of infer.adapt's make_adapt_step (synchronised)
    while active."""

    def __enter__(self):
        from speech_recognition_tools_tpu_torch.infer import adapt

        self.mod, self.orig, self.times = adapt, adapt.make_adapt_step, []
        orig, times = self.orig, self.times

        def timed_make(*a, **kw):
            step, opt = orig(*a, **kw)

            def timed(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                return out

            return timed, opt

        adapt.make_adapt_step = timed_make
        return self

    def __exit__(self, *exc):
        self.mod.make_adapt_step = self.orig


def adapt_phase(rng, dev, tmp):
    """Phase 14 (b): the demo recipe's stage 5 at timit_hybrid on the card:
    FDLP featgen (K1, counted, then held to its plain version on the path's
    lags) of ADAPT_UTTS held-out utterances with phase 6's CMVN as the
    unlabeled test set -> adapt_am.main of phase 6's AM (3 x 512 GRU,
    3,376 classes) against phase 13's pm_ae PM (2 + 2 x 512, bn 64), one
    epoch at batch ADAPT_BATCH, dev FER on phase 6's egs -> the adapted
    checkpoint reloaded -> pm_score_cli pm of the adapted AM. The first
    step's PM loss card vs CPU. Returns K1's launches."""
    import os

    from speech_recognition_tools_tpu_torch.cli import adapt_am, dump_outputs, pm_score_cli
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        fdlp_lags,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.infer.adapt import AdaptConfig, make_adapt_loss
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, iter_egs_batches, load_egs
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )

    t_phase = time.perf_counter()
    hyb = FdlpConfig()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    xa, la = speechlike_batch(rng, ADAPT_UTTS, 1.0, 2.5)
    t = {}
    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    feats, nfr = fdlp_spectrogram_batch(xa, la, hyb, device=dev)
    cfg_egs, _ = load_egs(j("hyb_egs"))
    cmvn = (np.asarray(cfg_egs.cmvn_mean), np.asarray(cfg_egs.cmvn_std))
    keys = [f"ad{b:02d}" for b in range(ADAPT_UTTS)]
    rows = [(k, feats[b, : int(nfr[b])].cpu().numpy()) for b, k in enumerate(keys)]
    build_egs(iter(rows), j("adapt_egs"), cmvn=cmvn)
    build_egs(iter(rows[:LIFELONG_UTTS]), j("ll_egs"), cmvn=cmvn)  # for (c)
    short = sorted(range(ADAPT_UTTS), key=lambda b: int(nfr[b]))[:ZOO_CPU_UTTS]
    build_egs(iter(rows[b] for b in short), j("adapt_small"), cmvn=cmvn)
    t["featgen + egs"] = time.perf_counter() - t0
    with _AdaptStepTimes() as steps:
        t["adapt_am"], res = _synced(lambda: adapt_am.main(
            [j("hyb_am"), j("pm"), j("adapt_egs"), j("adapted"), "--dev_egs_dir", j("hyb_egs"),
             "--epochs", "1", "--batch_size", str(ADAPT_BATCH), "--device", str(dev)]))
    t["pm_score_cli pm (adapted AM)"], scores = _synced(lambda: pm_score_cli.main(
        ["pm", j("adapted"), j("pm"), j("adapt_egs"), j("adapted_pm.pkl"), "--device",
         str(dev)]))
    torch.cuda.synchronize()
    launches = lpc_cepstra.launches
    assert launches > 0, "the adaptation path's featgen did not launch K1"
    assert len(steps.times) == -(-ADAPT_UTTS // ADAPT_BATCH), steps.times
    fers = [m["fer"] for m in res["dev"]]
    assert len(fers) == 2 and all(np.isfinite(fers)), res
    assert sorted(scores) == keys and all(np.isfinite(v) for v in scores.values())
    # the adapted checkpoint reloads, and moved away from phase 6's AM
    adapted, path, _ = dump_outputs.load_model_from_checkpoint(j("adapted"), dev)
    source, _, _ = dump_outputs.load_model_from_checkpoint(j("hyb_am"), dev)
    assert os.path.basename(path) == "adapted"
    moved = max((a - b).abs().max().item() for a, b in zip(adapted.state_dict().values(),
                                                           source.state_dict().values()))
    assert all(torch.isfinite(v).all() for v in adapted.state_dict().values()) and moved > 0
    # the first step's PM loss on the card and on the CPU
    small = next(iter_egs_batches(j("adapt_small"), ZOO_CPU_UTTS, drop_labels=True))
    loss = {}
    for d in (str(dev), "cpu"):
        am = dump_outputs.load_model_from_checkpoint(j("hyb_am"), d)[0]
        pm = dump_outputs.load_model_from_checkpoint(j("pm"), d)[0]
        fn = make_adapt_loss(am, pm, np.zeros(HYBRID_CLASSES, np.float32), AdaptConfig())
        with torch.no_grad():
            loss[d] = fn({k: torch.as_tensor(small[k], device=d)
                          for k in ("feats", "lengths")}).item()
    loss_rel = _rel(loss[str(dev)], loss["cpu"])
    assert np.isfinite(loss["cpu"]) and loss_rel <= ADAPT_LOSS_REL, loss
    # K1 on the path's own lags against its plain version
    r, _ = fdlp_lags(xa, la, hyb, device=dev)
    r = r.reshape(-1, r.shape[-1])
    got = lpc_cepstra(r, hyb.order, hyb.coeff_num)
    ref = lpc_cepstra_reference(r, hyb.order, hyb.coeff_num)
    ref64 = lpc_cepstra_reference(r.double(), hyb.order, hyb.coeff_num)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _, k1_t, k1_rel = cep_agreement(f"adaptation lags P={r.shape[0]}", got, ref)

    def to64(c):  # the worst per-coefficient distance to the float64 plain version
        err = (c.double() - ref64).abs().amax(0)
        return (err / ref64.abs().mean(0).clamp_min(1e-30)).max().item()

    log(f"[k1] adaptation lags: worst max|err_n|/mean|c_n| against the float64 plain version: "
        f"kernel {to64(got):.3e}, float32 plain {to64(ref):.3e}")
    assert k1_t <= MAIN_PATH_TOL and k1_rel <= ADAPT_K1_REL, (k1_t, k1_rel)

    log(f"[adapt] timit_hybrid: {ADAPT_UTTS} held-out utterances of 1-2.5 s "
        f"({int(nfr.sum())} frames) -> adapt_am of phase 6's AM against phase 13's PM, 1 epoch "
        f"at batch {ADAPT_BATCH} (adam, lr 1e-4, mse, no shift): ms a step (synchronised) "
        + ", ".join(f"{s * 1e3:.1f}" for s in steps.times)
        + f"; dev FER on phase 6's egs {fers[0]:.2f}% before, {fers[1]:.2f}% after; max "
        f"|adapted - source| {moved:.3e}; K1 launches {launches}")
    log(f"[adapt] first-step PM loss card {loss[str(dev)]:.6f}, rel to cpu {loss_rel:.2e} "
        f"(limit {ADAPT_LOSS_REL}); pm_score_cli pm of the adapted AM: {ADAPT_UTTS} scores, "
        f"sample {scores[keys[0]]:.4f}")
    log("[adapt] wall s by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
        + f"; phase 14 (b) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def lifelong_phase(dev, tmp):
    """Phase 14 (c): lifelong_decode.main on the card over LIFELONG_UTTS of
    (b)'s utterances with two task classifiers at timit_hybrid width (phase
    6's AM and a second seeded 3 x 512 GRU) and two seeded GRU VAEs at
    train_am's defaults (3 + 1 x 512, bn 64) over the features, or, for
    postpm, over the
    classifiers' 3,376 outputs (--pm_on posteriors); every fusion. Fused
    arks card vs CPU on ZOO_CPU_UTTS utterances; utterances a second."""
    import os

    from speech_recognition_tools_tpu_torch.cli import lifelong_decode, train_am

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    seeded = ["--epochs", "0", "--device", str(dev), "--seed"]
    train_am.main([j("hyb_egs"), j("ll_am1"), "--arch", "rnn", "--num_layers",
                   str(HYBRID_TRAIN["num_layers"]), "--hidden_dim",
                   str(HYBRID_TRAIN["hidden_dim"]), *seeded, "1"])
    vae = [*_argv(ZOO_TRAIN), "--arch", "vae"]
    for i in range(2):
        train_am.main([j("hyb_egs"), j(f"ll_vae{i}"), *vae, *seeded, str(i)])
        train_am.main([j("pm_egs"), j(f"ll_qvae{i}"), *vae, *seeded, str(i)])
    pcx = f"{j('hyb_am')},{j('ll_am1')}"
    priors = f"{j('prior.pkl')},{j('prior.pkl')}"
    rows = []
    for fusion, (task_prior, *extra) in LIFELONG_RUNS.items():
        px = "ll_qvae" if fusion == "postpm" else "ll_vae"
        argv = [pcx, f"{j(px + '0')},{j(px + '1')}"]
        flags = ["--fusion", fusion, *extra]
        t_run, out = _synced(lambda: lifelong_decode.main(
            [*argv, j("ll_egs"), priors, task_prior, j(f"ll_{fusion}"), *flags, "--device",
             str(dev)]))
        assert len(out) == LIFELONG_UTTS and all(np.isfinite(v).all() for v in out.values()), \
            fusion
        both = {d: lifelong_decode.main([*argv, j("adapt_small"), priors, task_prior,
                                         j(f"ll_{fusion}_{d}"), *flags, "--device", d])
                for d in (str(dev), "cpu")}
        rel = _max_rel(both[str(dev)], both["cpu"])
        assert rel <= LIFELONG_REL, (fusion, rel)
        rows.append((fusion, task_prior, extra, t_run, rel))
    for fusion, tp, extra, t_run, rel in rows:
        log(f"[lifelong] --fusion {fusion:11s} {tp:6s} {' '.join(extra):21s} "
            f"{LIFELONG_UTTS / t_run:6.1f} utterances a second ({t_run:.2f} s, 2 classifiers + "
            f"2 VAEs on the card, fusion on the host); card vs cpu {rel:.2e} of scale (limit "
            f"{LIFELONG_REL})")
    log(f"[lifelong] phase 14 (c) took {time.perf_counter() - t_phase:.1f} s")


def cl_phase(e2e, dev, tmp):
    """Phase 14 (d): recog_e2e.main --api cl over phase 5's and phase 7's
    wsj_fdlp_e2e models (12 / 6 layers, one 52-token vocabulary) with
    --pm_scores CL_PM_SCORES, beam 10, max_len CL_MAX_LEN, over one copy of
    each of phase 7's utterances, one at a time: ms a search step; the hypotheses card vs
    CPU on CL_CPU_UTTS utterances; --compute_dtype bfloat16 once, its
    best hypotheses' fused scores finite."""
    import json
    import os

    from speech_recognition_tools_tpu_torch.cli import recog_e2e
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, iter_egs_batches, load_egs
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_to_jax
    from speech_recognition_tools_tpu_torch.io.text import decode_tokens, save_vocab
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        cl_decode,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    asr = e2e["asr"]
    cfg_egs, utts = load_egs(j("e2e_egs"))
    hyper = dict(model_class="TransformerASR", **E2E_AM, mtlalpha=0.3, lsm_weight=0.1,
                 encoder_type="transformer", feature_dim=cfg_egs.feat_dim)
    save_checkpoint(j("cl_m5"), "final_avg", transformer_asr_to_jax(
        asr.state_dict(), E2E_AM["aheads"]), hyper)
    save_vocab(e2e["vocab"], j("cl_m5", "vocab.json"))
    with open(j("e2e_am", "vocab.json")) as fh:
        assert json.load(fh) == e2e["vocab"], "phase 5's and phase 7's vocabularies differ"
    dirs = f"{j('cl_m5')},{j('e2e_am')}"
    # phase 7's egs hold each utterance twice (keys ...a, ...b): one copy each
    # (the search over both copies cut to one for time)
    once = [u for u in utts if u[0].endswith("a")]
    build_egs(((k, f) for k, f, _ in once), j("cl_egs"))
    short = sorted(once, key=lambda u: len(u[1]))[:CL_CPU_UTTS]
    build_egs(((k, f) for k, f, _ in short), j("cl_small"))
    cl = ["--api", "cl", "--pm_scores", CL_PM_SCORES, "--beam_size", "10", "--max_len",
          str(CL_MAX_LEN)]

    calls = [0]
    orig = TransformerASR.decode_step

    def counted(self, *a, **kw):
        calls[0] += 1
        return orig(self, *a, **kw)

    TransformerASR.decode_step = counted
    try:
        t_cl, hyps = _synced(lambda: recog_e2e.main(
            [dirs, j("cl_egs"), j("cl_hyp.txt"), *cl, "--device", str(dev)]))
    finally:
        TransformerASR.decode_step = orig
    steps = calls[0] // 2
    assert len(hyps) == len(once) and all(isinstance(h, str) for h in hyps.values())
    empty = sum(not h for h in hyps.values())
    small = {d: recog_e2e.main([dirs, j("cl_small"), j(f"cl_small_{d}.txt"), *cl, "--device",
                                d]) for d in (str(dev), "cpu")}
    assert small[str(dev)] == small["cpu"], small
    t_bf16, hyps16 = _synced(lambda: recog_e2e.main(
        [dirs, j("cl_small"), j("cl_small_bf16.txt"), *cl, "--compute_dtype", "bfloat16",
         "--device", str(dev)]))
    # the bf16 search again (cl_decode on the CLI's padded batches), its
    # best hypotheses rescored by its own models
    models = [recog_e2e._load(d, "final_avg", "bfloat16", device=dev)[0]
              for d in dirs.split(",")]
    pm = [float(v) for v in CL_PM_SCORES.split(",")]
    w = np.exp(300.0 * np.asarray(pm)) / np.exp(300.0 * np.asarray(pm)).sum()
    cfg, scores16 = models[0].cfg, []
    for b in iter_egs_batches(j("cl_small"), 1, drop_labels=True):
        x = torch.as_tensor(b["feats"], device=dev)
        n = torch.as_tensor(b["lengths"], device=dev)
        toks = cl_decode(models, pm, x, n, cfg, beam_size=10, max_len=CL_MAX_LEN)
        assert decode_tokens(toks, e2e["vocab"]) == hyps16[b["keys"][0]]
        toks = toks + ([cfg.eos_id] if len(toks) < CL_MAX_LEN else [])
        score = 0.0
        with torch.no_grad():
            for wk, m in zip(w, models):
                mem, el, _ = m.encode(x, n)
                prefix = torch.tensor([[cfg.sos_id, *toks[:-1]]], device=dev)
                lp = torch.log_softmax(m.decode_step(prefix, mem, el)[0].float(), -1)
                score += float(wk) * lp[torch.arange(len(toks)), torch.tensor(toks)].sum().item()
        scores16.append(score)
    assert all(np.isfinite(scores16)), scores16
    log(f"[cl] recog_e2e --api cl over phase 5's and phase 7's models ({E2E_AM['elayers']}/"
        f"{E2E_AM['dlayers']} layers, --pm_scores {CL_PM_SCORES}: weights "
        f"{w[0]:.3f} / {w[1]:.3f}), beam 10, max_len {CL_MAX_LEN}, over {len(once)} of phase "
        f"7's utterances: {t_cl:.2f} s, {steps} search steps, {t_cl / max(steps, 1) * 1e3:.2f} ms "
        f"a step (both models' full-prefix decoders, the ranking, the encoders' share "
        f"included); {empty} empty hypotheses (no length normalisation: a beam that ends "
        f"early keeps its score); {len(small['cpu'])} utterances card vs cpu token-identical "
        f"({sum(len(h) for h in small['cpu'].values())} characters); bf16 "
        f"({t_bf16:.2f} s for {len(short)} utterances) best fused scores "
        + ", ".join(f"{v:.3f}" for v in scores16)
        + f"; phase 14 (d) took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 15


def _k1_on_path(tag, r, order, lim, tol, rel):
    """K1 against its plain version on a path's own lags r (P, order+2):
    the agreement (asserted within tol / rel, cep_agreement's measures),
    kernel ms (CUDA-graph replay), plain ms and the bound, logged."""
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )

    got = lpc_cepstra(r, order, lim)
    ref = lpc_cepstra_reference(r, order, lim)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), tag
    err, t_need, worst = cep_agreement(f"{tag} lags P={r.shape[0]}", got, ref)
    assert t_need <= tol and worst <= rel, (tag, t_need, worst)
    ms = graph_ms(lambda: lpc_cepstra(r, order, lim))
    plain = cuda_ms(lambda: lpc_cepstra_reference(r, order, lim), reps=1, repeats=3)
    bound, by = bound_ms(*k1_work(r.shape[0], order, lim))
    log(f"[k1] {tag} lags P={r.shape[0]} order={order} lim={lim}: max|kernel - plain|="
        f"{err:.3e} kernel_ms={ms:.4f} plain_ms={plain:.3f} bound_ms={bound:.5f} ({by})")
    return err


def _int8_rounds(model, S, idim, rng, dev, tag, profile):
    """The batched encoder step at S full rows of idim-wide features, 10
    rounds: (ms a round wall, and with `profile` ms device busy a round and
    device activities a round, else or without device time None)."""
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import StreamBatcher, _posenc_rows

    cfg = model.cfg
    sb = StreamBatcher(model, max_streams=S)
    chunk = cfg.attn_chunk
    xs = torch.as_tensor(rng.standard_normal((S, 4 * chunk + 3, idim)).astype(np.float32),
                         device=dev)
    pe = torch.as_tensor(np.stack([_posenc_rows(64, chunk, cfg.adim)] * S), device=dev)
    nv = torch.full((S,), chunk, device=dev)
    up = torch.ones((S,), dtype=torch.bool, device=dev)

    def rounds():
        for _ in range(10):
            _, ctc, sb.caches = sb.step(xs, pe, nv, up, sb.caches)
        return ctc.cpu()

    t, _ = wall_s(rounds, repeats=2)
    prof = profile and device_breakdown(f"{tag}, 10 batched rounds of {S} streams", rounds,
                                        top=4)
    if not prof:
        return 1e3 * t / 10, None, None
    return 1e3 * t / 10, prof[1] / 10 / 1e3, prof[2] / 10


def _int8_vs_f32(q_model, f_model, feats, nfr, mean, std, dev):
    """int8 against float32, offline chunked encode of the normalised
    utterances: (max |memory diff| over valid frames, CTC argmax agreement)."""
    f = ((feats - mean) / std) * (torch.arange(feats.shape[1], device=feats.device)[None, :, None]
                                 < nfr[:, None, None])
    with torch.no_grad():
        mq, n, cq = q_model.encode(f.to(dev), nfr.to(dev))
        mf, _, cf = f_model.encode(f.to(dev), nfr.to(dev))
    valid = torch.arange(mq.shape[1], device=dev)[None, :] < n[:, None]
    diff = (mq - mf).abs()[valid].max().item()
    agree = (cq.argmax(-1) == cf.argmax(-1))[valid].float().mean().item()
    return diff, agree


def int8_phase(x, lens, fdlp_cfg, feats, nfr, rng, dev, tmp):
    """Phase 15 (a): int8 serving on phase 8's wsj_fdlp_e2e model directory
    (12 / 6 layers, adim 256, FFN 2048, attn_chunk 16 / left 4, serving.json,
    CMVN) and phase 10 (b)'s conformer directory. `feats`, `nfr` are phase
    3's batch features. Returns K1's launches over the int8 served streams,
    the int8 transcribe CLI and the int8 conformer pipelines."""
    from speech_recognition_tools_tpu_torch.cli import recog_e2e, serve, transcribe
    from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp
    from speech_recognition_tools_tpu_torch.infer.quantize import (
        quantize_encoder,
        quantized_bytes,
    )
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import (
        OnlineASRPipeline,
        StreamBatcher,
        StreamingRecognizer,
    )
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

    t_phase = time.perf_counter()
    model_dir = os.path.join(tmp, "serve_am")

    def load(int8, device=dev, d=model_dir):
        """(model, the device memory it took: 0 on the CPU)."""
        card = str(device) != "cpu"
        if card:
            torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() if card else 0
        m, _, _ = recog_e2e._load(d, "final_avg", device=device)
        if int8:
            quantize_encoder(m)
        return m, (torch.cuda.memory_allocated() - before) if card else 0

    f_model, f_bytes = load(False)
    q_model, q_bytes = load(True)
    qb, fb = quantized_bytes(q_model.encoder)
    n_q = sum(t.numel() for t in q_model.encoder.state_dict().values() if t.dtype == torch.int8)
    blob = np.load(os.path.join(model_dir, "cmvn.npz"))
    mean = torch.as_tensor(blob["mean"], device=feats.device)
    std = torch.as_tensor(blob["std"], device=feats.device)

    # ---- the main path: make_server(int8=True), 8 concurrent socket streams ----
    S = SERVE_STREAMS
    step = int(SERVE_PUSH_S * fdlp_cfg.srate)
    sigs = [x[b, : int(lens[b])] for b in range(S)]
    pipe = OnlineASRPipeline.from_model_dir(model_dir, int8=True, device=dev)
    server, port = serve.make_server(model_dir, max_streams=S, defer_s=SERVE_DEFER_S, int8=True,
                                     device=dev)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        results = [None] * S

        def run(i):
            results[i] = _serve_client(port, sigs[i], step)

        lpc_cepstra.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(S)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        t_served = max(r["t_end"] for r in results) - t0
        torch.cuda.synchronize()
        serve_launches = lpc_cepstra.launches
        rounds = server.service.batcher.rounds
    finally:
        server.shutdown()
        server.server_close()
    assert serve_launches > 0, "the int8 serving path did not launch K1"
    mismatched = 0
    for sig, res in zip(sigs, results):
        want, rows = _pipeline_run(pipe, sig, step)
        fin = res["final"]
        assert fin["frames"] == rows.shape[0] and np.isfinite(rows).all()
        if fin["tokens"] != want:
            mismatched += 1
            assert _ctc_near_ties(rows) > 0, (fin["tokens"], want)

    # ---- transcribe --int8 on phase 8's two wavs ----
    wavs = [os.path.join(tmp, f"serve_utt{b}.wav") for b in range(2)]
    out = os.path.join(tmp, "int8_transcribe.txt")
    lpc_cepstra.launches = 0
    transcribe.main([model_dir, *wavs, "--int8", "--out", out, "--device", str(dev)])
    transcribe_launches = lpc_cepstra.launches
    assert transcribe_launches > 0, "transcribe --int8 did not launch K1"
    with open(out) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 2
    for b, line in enumerate(lines):
        want, rows = _pipeline_run(pipe, sigs[b], len(sigs[b]))
        text = pipe.recognizer.text(want).strip()
        assert line == f"serve_utt{b} {text}".rstrip() or _ctc_near_ties(rows) > 0, (line, text)

    # ---- int8 streamed memory, card against CPU (the same codes) ----
    cpu_model, _ = load(True, device="cpu")
    cpu_sd = cpu_model.state_dict()
    for k, v in q_model.state_dict().items():
        if v.dtype == torch.int8 or k.endswith("weight.0.scale"):
            assert torch.equal(v.cpu(), cpu_sd[k]), k
    mem_err = 0.0
    for b in range(1):
        f = ((feats[b, : int(nfr[b])] - mean) / std).cpu().numpy()
        mems = []
        for m in (q_model, cpu_model):
            sr = StreamingRecognizer(m)
            for off in range(0, f.shape[0], 25):
                sr.push(f[off : off + 25])
            sr.finish()
            mems.append(sr.memory)
        mem_err = max(mem_err, float(np.abs(mems[0] - mems[1]).max()))
    assert mem_err <= INT8_MEM_ATOL, mem_err
    # int8 against the float32 offline chunked encode, phase 3's 8 utterances
    q_diff, q_agree = _int8_vs_f32(q_model, f_model, feats[:S], nfr[:S], mean, std, dev)
    assert np.isfinite(q_diff) and q_diff <= INT8_VS_F32_ATOL, q_diff
    assert q_agree >= INT8_CTC_AGREE, q_agree
    t_checks = time.perf_counter()

    # ---- one round, int8 against float32, in turns ----
    idim = fdlp_cfg.nfilters

    def in_turns(f32, int8, rows, tag):
        """_int8_rounds in turns (f32, int8, int8, f32), each model profiled
        in its first turn: {name: [readings]}."""
        out = {"f32": [], "int8": []}
        for name, m in (("f32", f32), ("int8", int8), ("int8", int8), ("f32", f32)):
            out[name].append(_int8_rounds(m, rows, idim, rng, dev, f"{tag} {name}",
                                          profile=not out[name]))
        return out

    def med(d, tag, i):
        vals = [r[i] for r in d[tag] if r[i] is not None]
        return statistics.median(vals) if vals else None

    t_timing = time.perf_counter()
    times = in_turns(f_model, q_model, S, "serve encoder")
    t_timing = time.perf_counter() - t_timing

    def fmt(d, i, unit):
        v = med(d, "f32" if unit[0] == "f" else "int8", i)
        return f"{unit[1:]} not measured" if v is None else f"{v:.3f} {unit[1:]}"

    log(f"[int8] wsj_fdlp_e2e encoder ({q_model.cfg.elayers} layers, adim {q_model.cfg.adim}, "
        f"FFN {q_model.cfg.eunits}): {n_q} weights int8; quantized_bytes {qb} / {fb} "
        f"(int8 form / float32 equivalent, ratio {fb / qb:.2f}); device memory of the model "
        f"{f_bytes / 2**20:.1f} MiB float32, {q_bytes / 2**20:.1f} MiB with the int8 encoder")
    audio_s = float(sum(len(s_) for s_ in sigs)) / fdlp_cfg.srate
    log(f"[int8] make_server(int8=True, max_streams {S}): {S} concurrent streams of "
        f"{audio_s:.1f} s audio in {SERVE_PUSH_S} s messages, unpaced: {t_served:.2f} s wall = "
        f"{audio_s / t_served:.1f} audio s per wall s, {rounds} batched rounds; "
        f"{S - mismatched} of {S} finals token-identical to the int8 OnlineASRPipeline "
        f"({mismatched} at CTC near-ties); K1 launches {serve_launches}; transcribe --int8 "
        f"on 2 wavs equals the pipeline (K1 launches {transcribe_launches}); serving and its "
        f"checks {t_checks - t_phase:.1f} s, the round timings {t_timing:.1f} s")
    log(f"[int8] streamed memory, int8 card vs int8 CPU (same codes): max|err| {mem_err:.3e} "
        f"(atol {INT8_MEM_ATOL}); int8 vs float32 offline chunked encode on {S} utterances: "
        f"max|memory diff| {q_diff:.3e} (limit {INT8_VS_F32_ATOL}), CTC argmax agreement "
        f"{100 * q_agree:.2f}% (limit {100 * INT8_CTC_AGREE:.0f}%)")
    log(f"[int8] one round at {S} full rows (wall: median of 2 turns each, in turns f32, int8, "
        f"int8, f32; device: the first turn's profile): float32 {fmt(times, 0, 'fms wall')}, "
        f"{fmt(times, 1, 'fms device')}, {fmt(times, 2, 'fdevice activities')}; int8 "
        f"{fmt(times, 0, 'ims wall')}, {fmt(times, 1, 'ims device')}, "
        f"{fmt(times, 2, 'idevice activities')} (eager "
        f"dequantization: one multiply per weight per call)")

    # ---- the conformer of phase 10 (b), 5 streams ----
    conf_dir = os.path.join(tmp, "conf_stream")
    cq, _ = load(True, d=conf_dir)
    cf, _ = load(False, d=conf_dir)
    blob = np.load(os.path.join(conf_dir, "cmvn.npz"))
    cmean, cstd = blob["mean"], blob["std"]
    cpipe = OnlineASRPipeline.from_model_dir(conf_dir, int8=True, device=dev)
    C = INT8_CONF_STREAMS
    lpc_cepstra.launches = 0
    want, rows = [], []
    for sig in sigs[:C]:
        tok, ctc_rows = _pipeline_run(cpipe, sig, step)
        want.append(tok)
        rows.append(ctc_rows)
    conf_launches = lpc_cepstra.launches
    assert conf_launches > 0, "the int8 conformer stream did not launch K1"
    sfeats = []
    for sig in sigs[:C]:
        sf = StreamingFdlp(fdlp_cfg, device=dev)
        outs = [sf.process(sig[off : off + step]) for off in range(0, len(sig), step)]
        outs.append(sf.finish())
        sfeats.append((np.concatenate(outs) - cmean) / cstd)
    sb = StreamBatcher(cq, max_streams=C)
    sids = [sb.open() for _ in range(C)]
    offs = [0] * C
    while any(offs[i] < len(sfeats[i]) for i in range(C)):
        for i in range(C):
            if offs[i] < len(sfeats[i]):
                sb.push(sids[i], sfeats[i][offs[i] : offs[i] + 25])
                offs[i] += 25
    c_mismatched = 0
    for i in range(C):
        if sb.finish(sids[i]) != want[i]:
            c_mismatched += 1
            assert _ctc_near_ties(rows[i]) > 0, i
    cmean_t = torch.as_tensor(cmean, device=feats.device)
    cstd_t = torch.as_tensor(cstd, device=feats.device)
    c_diff, c_agree = _int8_vs_f32(cq, cf, feats[:C], nfr[:C], cmean_t, cstd_t, dev)
    assert np.isfinite(c_diff) and c_diff <= INT8_VS_F32_ATOL, c_diff
    assert c_agree >= INT8_CTC_AGREE, c_agree
    ctimes = in_turns(cf, cq, C, "conformer encoder")
    log(f"[int8] conformer (phase 10 (b)): {C} streams through an int8 StreamBatcher: "
        f"{C - c_mismatched} of {C} finals token-identical to int8 OnlineASRPipelines "
        f"({c_mismatched} at CTC near-ties), K1 launches {conf_launches}; int8 vs float32 "
        f"offline chunked encode: max|memory diff| {c_diff:.3e} (limit {INT8_VS_F32_ATOL}), "
        f"CTC argmax agreement {100 * c_agree:.2f}%; one round at {C} rows: float32 "
        f"{fmt(ctimes, 0, 'fms wall')}, {fmt(ctimes, 1, 'fms device')}; int8 "
        f"{fmt(ctimes, 0, 'ims wall')}, {fmt(ctimes, 1, 'ims device')}; phase 15 (a) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return serve_launches, transcribe_launches, conf_launches


def seeded_words(rng, letters, n, lo=2, hi=9):
    """n distinct seeded words of lo..hi-1 letters, in the order drawn."""
    words, seen = [], set()
    while len(words) < n:
        lens_ = rng.randint(lo, hi, n)
        idx = rng.randint(0, len(letters), (n, hi))
        for L, row in zip(lens_, idx):
            w = "".join(letters[i] for i in row[:L])
            if w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == n:
                    break
    return words


def wordlm_phase(x, lens, fdlp_cfg, rng, dev, tmp):
    """Phase 15 (b): the look-ahead word LM. A seeded WORDLM_VOCAB-word
    lexicon spelled in phase 5's 48 letters and transcripts that use every
    word; train_lm.main --unit word at the CLI defaults (1 x 1000 GRU, embed
    256, batch 64, bptt 128), one epoch; recog_e2e.main --word_lm_dir
    --word_lm_dict with phase 5's model (phase 14 (d)'s cl_m5 directory) on
    WORDLM_UTTS of phase 3's utterances (FDLP on K1, counted), beam 10,
    max_len WORDLM_MAX_LEN, offline and --streaming (attn_chunk 16 / left 4
    at decode time); hypotheses card vs CPU on WORDLM_CPU_UTTS; ms a search
    step by part. Returns K1's launches over the decode set's featgen."""
    from speech_recognition_tools_tpu_torch.cli import recog_e2e, train_lm
    from speech_recognition_tools_tpu_torch.decode.wordlm import (
        LookaheadWordLM,
        word_vocab_from_dict,
    )
    from speech_recognition_tools_tpu_torch.dsp.fdlp import fdlp_lags, fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.text import load_vocab
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam
    from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn, cmvn_stats_masked

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    vocab = load_vocab(j("cl_m5", "vocab.json"))
    letters = sorted(c for c in vocab if len(c) == 1)
    words = seeded_words(rng, letters, WORDLM_VOCAB - 2)
    order = rng.permutation(len(words))
    texts, i = {}, 0
    while i < len(order):
        n = int(rng.randint(*WORDLM_TEXT_WORDS))
        texts[f"w{len(texts):05d}"] = " ".join(words[k] for k in order[i : i + n])
        i += n
    with open(j("wlm_text"), "w") as fh:
        fh.writelines(f"{k} {v}\n" for k, v in texts.items())
    store = j("wlm")
    t_main, nll = _synced(lambda: train_lm.main(
        [j("wlm_text"), store, "--unit", "word", "--word_vocab_size", str(WORDLM_VOCAB),
         "--epochs", "1", "--device", str(dev)]))
    wvocab = load_vocab(j("wlm", "vocab.json"))
    assert len(wvocab) == WORDLM_VOCAB and wvocab["<eos>"] == 0 and np.isfinite(nll).all()
    with open(j("wlm_dict.txt"), "w") as fh:
        fh.writelines(f"{w} {k}\n" for w, k in wvocab.items())
    assert word_vocab_from_dict(j("wlm_dict.txt"), n_vocab=WORDLM_VOCAB) == wvocab

    # a step's time and tokens/s, and the first step's loss card vs CPU
    d = dict(embed_dim=256, hidden=1000, layers=1)
    batches = list(train_lm.lm_batches(texts, wvocab, 64, 128, seed=0, unit="word"))

    def fresh(device):
        m = RNNLM(WORDLM_VOCAB, d["embed_dim"], d["hidden"], d["layers"], device=device)
        m.reset_parameters(torch.Generator().manual_seed(3))
        opt = ClipAdam(1e-3, None, inject=False)
        return m, opt, train_lm.make_train_step(m, opt)

    toks, lens_b = batches[0][0][:LM_STEP_CPU_SEQS], batches[0][1][:LM_STEP_CPU_SEQS]
    toks = toks[:, : int(lens_b.max())]
    losses = {}
    for device in ("cpu", dev):
        m, opt, stp = fresh(device)
        _, loss = stp(opt.init(dict(m.named_parameters())),
                      torch.as_tensor(toks, device=device).long(),
                      torch.as_tensor(lens_b, device=device).long())
        losses[str(device)] = loss.item()
    l_c, l_g = losses["cpu"], losses[str(dev)]
    assert _rel(l_g, l_c) <= 1e-5, (l_g, l_c)
    m, opt, stp = fresh(dev)
    ost = opt.init(dict(m.named_parameters()))
    full = (torch.as_tensor(batches[0][0], device=dev).long(),
            torch.as_tensor(batches[0][1], device=dev).long())
    t_step, (ost, _) = wall_s(lambda: stp(ost, *full))
    n_tok = int((full[1] - 1).sum())
    del m, opt, stp, ost

    # the decode set: phase 3's utterances, FDLP on K1, CMVN, egs
    U = WORDLM_UTTS
    lpc_cepstra.launches = 0
    f, n = fdlp_spectrogram_batch(x[:U], lens[:U], fdlp_cfg, device=dev)
    torch.cuda.synchronize()
    launches = lpc_cepstra.launches
    assert launches > 0, "the word-LM decode set's featgen did not launch K1"
    r, _ = fdlp_lags(x[:U], lens[:U], fdlp_cfg, device=dev)
    # order-150 FDLP lags: phase 2's limits for them
    k1_err = _k1_on_path("word-LM decode set", r.reshape(-1, r.shape[-1]), fdlp_cfg.order,
                         fdlp_cfg.coeff_num, NEAR_PERIODIC_TOL, NEAR_PERIODIC_REL)
    f = apply_cmvn(f, *cmvn_stats_masked(f, n))
    build_egs(((f"utt{b}", f[b, : int(n[b])].cpu().numpy()) for b in range(U)), j("wlm_egs"))
    build_egs(((f"utt{b}", f[b, : int(n[b])].cpu().numpy()) for b in range(WORDLM_CPU_UTTS)),
              j("wlm_egs_cpu"))
    common = ["--word_lm_dir", store, "--word_lm_dict", j("wlm_dict.txt"), "--beam_size",
              str(E2E_BEAM["beam_size"]), "--max_len", str(WORDLM_MAX_LEN)]
    K2.reset()
    GRAPHS.reset()
    t_off, hyps = _synced(lambda: recog_e2e.main(
        [j("cl_m5"), j("wlm_egs"), j("wlm_hyp.txt"), *common, "--device", str(dev)]))
    K2.read("wordlm_decode")
    GRAPHS.read("wordlm_decode")
    t_str, hyps_s = _synced(lambda: recog_e2e.main(
        [j("cl_m5"), j("wlm_egs"), j("wlm_hyp_stream.txt"), *common, "--streaming",
         "--attn_chunk", str(SERVE_CHUNK["attn_chunk"]), "--attn_left_chunks",
         str(SERVE_CHUNK["attn_left_chunks"]), "--device", str(dev)]))
    assert len(hyps) == len(hyps_s) == U
    # the same utterances' features decoded on the CPU: the card's hypotheses
    t_cpu, cpu_hyps = _synced(lambda: recog_e2e.main(
        [j("cl_m5"), j("wlm_egs_cpu"), j("wlm_hyp_cpu.txt"), *common, "--device", "cpu"]))
    assert len(cpu_hyps) == WORDLM_CPU_UTTS
    assert all(cpu_hyps[k] == hyps[k] for k in cpu_hyps), (cpu_hyps, hyps)

    # ms a search step by part, on the first utterance
    model, _, _ = recog_e2e._load(j("cl_m5"), "final_avg", device=dev)
    wlm = LookaheadWordLM(recog_e2e._load_lm(store, device=dev), wvocab, vocab)
    calls = [0]

    def scorer(prefix):
        calls[0] += 1
        return wlm(prefix)

    with torch.no_grad():
        mem, el, ctc = model.encode(f[:1], n[:1])
    _, timings = span_seconds(lambda: beam_search_encoded(
        model, mem, el, ctc, max_len=WORDLM_MAX_LEN, prefix_scorer=scorer, **E2E_BEAM))
    steps = max(calls[0], 1)
    st = dict(wlm.stats)
    device_breakdown("word-LM search, 5 steps", lambda: beam_search_encoded(
        model, mem, el, ctc, max_len=5, prefix_scorer=wlm, **E2E_BEAM), top=4)
    lookups = st["hits"] + st["misses"]
    per = {k[len("search."):]: 1e3 * v / steps for k, (v, _) in timings.items()
           if k.startswith("search.")}
    log(f"[wordlm] train_lm.main --unit word --word_vocab_size {WORDLM_VOCAB}: "
        f"{len(texts)} transcripts, {len(batches)} batches of 64 (bptt 128), 1 x 1000 GRU, "
        f"embed 256: one epoch {t_main:.2f} s (checkpoints included), nll {nll[0]:.4f}; a step "
        f"at B={len(batches[0][1])} x U={batches[0][0].shape[1]}: {1e3 * t_step:.1f} ms = "
        f"{n_tok / t_step:.0f} tokens/s; first-step loss card {l_g:.6f} / CPU {l_c:.6f} on "
        f"{LM_STEP_CPU_SEQS} sequences (rel {_rel(l_g, l_c):.3e}, limit 1e-5)")
    log(f"[wordlm] recog_e2e --word_lm_dir --word_lm_dict, phase 5's model, {U} utterances "
        f"(FDLP on K1: {launches} launches, vs plain {k1_err:.3e}), beam "
        f"{E2E_BEAM['beam_size']}, max_len "
        f"{WORDLM_MAX_LEN}: offline {t_off:.2f} s, --streaming (attn_chunk "
        f"{SERVE_CHUNK['attn_chunk']} / left {SERVE_CHUNK['attn_left_chunks']}) {t_str:.2f} s; "
        f"hypotheses card vs CPU identical on {WORDLM_CPU_UTTS} (CPU {t_cpu:.2f} s); "
        f"hypothesis words {[len(h.split()) for h in hyps.values()]}")
    log(f"[wordlm] one search of {steps} steps, ms a step: decoder {per.get('decoder', 0):.2f}, "
        f"CTC {per.get('ctc_prefix', 0):.2f}, word LM {per.get('lm', 0):.2f} (device "
        f"{1e3 * st['device_s'] / steps:.2f}, host tree walk {1e3 * st['host_s'] / steps:.2f}), "
        f"top-k {per.get('topk', 0):.2f}, update {per.get('update', 0):.2f}; LRU hit rate "
        f"{100 * st['hits'] / max(lookups, 1):.1f}% of {lookups} history lookups; phase 15 (b) "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return launches


def align_phase(xh, lh, rng, dev, tmp):
    """Phase 15 (c): forced alignment at timit_hybrid's front-end. Phase 4's
    utterances through FDLP (K1, counted, then held to its plain version on
    the path's lags) and CMVN, written as feats.scp; a seeded ALIGN_WORDS-word
    lexicon over ALIGN_PHONES phones (silence phone 0) and transcripts the
    frames can carry; force_align.main at its CLI defaults with
    ALIGN_FLAGS; one batch's pseudo log-likelihoods aligned card vs CPU;
    ali_utils convert and combine on the result. Returns K1's launches."""
    import pickle

    from speech_recognition_tools_tpu_torch.align import (
        HmmTopology,
        read_lexicon,
        trailing_optional,
        utterance_states,
        viterbi_align_batch,
    )
    from speech_recognition_tools_tpu_torch.cli import ali_utils, force_align
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        fdlp_lags,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn, cmvn_stats_masked

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    hyb = FdlpConfig()  # timit_hybrid: 20 bands, order 50, 0.5 s
    lpc_cepstra.launches = 0
    feats, nfr = fdlp_spectrogram_batch(xh, lh, hyb, device=dev)
    torch.cuda.synchronize()
    launches = lpc_cepstra.launches
    assert launches > 0, "the alignment corpus's featgen did not launch K1"
    r, _ = fdlp_lags(xh, lh, hyb, device=dev)
    k1_err = _k1_on_path("alignment", r.reshape(-1, r.shape[-1]), hyb.order, hyb.coeff_num,
                         MAIN_PATH_TOL, MAIN_PATH_REL)
    feats = apply_cmvn(feats, *cmvn_stats_masked(feats, nfr))
    utts = {f"a{b:02d}": feats[b, : int(nfr[b])].cpu().numpy() for b in range(len(lh))}
    write_ark_scp(utts, j("ali_feats"))

    lexicon = {f"w{k:03d}": [int(p) for p in rng.randint(1, ALIGN_PHONES, rng.randint(2, 7))]
               for k in range(ALIGN_WORDS)}
    lexicon["w000"][0] = ALIGN_PHONES - 1  # every phone id up to 47 in the topology
    with open(j("ali_lexicon.txt"), "w") as fh:
        fh.writelines(f"{w} {' '.join(map(str, ps))}\n" for w, ps in lexicon.items())
    names = sorted(lexicon)
    texts = {}
    for u, f in utts.items():
        # words while their states (3 a phone) fill at most a third of the frames
        ws, states = [], 10
        while True:
            w = names[rng.randint(len(names))]
            if ws and states + 3 * len(lexicon[w]) + 3 > f.shape[0] // 3:
                break
            ws.append(w)
            states += 3 * len(lexicon[w]) + 3
        texts[u] = " ".join(ws)
    with open(j("ali_text"), "w") as fh:
        fh.writelines(f"{u} {t}\n" for u, t in texts.items())

    history = []
    t_align, ((labels, num_pdfs), tm) = _synced(lambda: span_seconds(lambda: force_align.main(
        [j("ali_feats.scp"), j("ali_text"), j("ali_lexicon.txt"), j("ali.pkl"), *ALIGN_FLAGS,
         "--device", str(dev)], history=history)))
    with open(j("ali.pkl"), "rb") as fh:
        ali = pickle.load(fh)
    assert sorted(ali) == sorted(utts) and len(history) >= 1
    assert all(len(ali[u]) == utts[u].shape[0] and ali[u].max() < num_pdfs for u in ali)
    n_batches = len(history) * -(-len(utts) // 8)

    # one batch's pseudo log-likelihoods, aligned on the card and on the CPU
    topo = HmmTopology(ALIGN_PHONES, 3, 0, silence_states=5, wpd_silence=True)
    assert topo.num_pdfs == num_pdfs
    lex = read_lexicon(j("ali_lexicon.txt"))
    batch = sorted(utts)[:8]
    chains = []
    for u in batch:
        p, sk, st = utterance_states(texts[u].split(), lex, topo=topo)
        chains.append((p, sk, st, trailing_optional(p, sk, 0, 3, topo=topo)))
    T = max(utts[u].shape[0] for u in batch)
    fb = np.zeros((len(batch), T, hyb.nfilters), np.float32)
    for b, u in enumerate(batch):
        fb[b, : utts[u].shape[0]] = utts[u]
    lb = torch.as_tensor([utts[u].shape[0] for u in batch], device=dev)
    am = RNNClassifier(hyb.nfilters, 1, 96, num_pdfs, device=dev)
    am.reset_parameters(torch.Generator().manual_seed(5))
    counts = np.bincount(np.concatenate(list(ali.values())), minlength=num_pdfs)
    prior = torch.as_tensor(np.log((counts + 1.0) / (counts.sum() + num_pdfs)).astype(np.float32),
                            device=dev)
    with torch.no_grad():
        pseudo = torch.log_softmax(am(torch.as_tensor(fb, device=dev), lb), -1) - prior
    card = viterbi_align_batch(pseudo, lb.cpu().numpy(), chains)
    cpu = viterbi_align_batch(pseudo.cpu(), lb.cpu().numpy(), chains)
    device_breakdown("Viterbi DP + traceback, a batch of 8", lambda: viterbi_align_batch(
        pseudo, lb.cpu().numpy(), chains), top=4)
    worst = 0.0
    for (la, sa), (lc, sc) in zip(card, cpu):
        assert la is not None and lc is not None and np.array_equal(la, lc)
        worst = max(worst, _rel(sa, sc))
    assert worst <= 1e-5, worst

    # ali_utils convert (pdf -> its phone) and combine (ali.pkl twice)
    pdf_phone = np.searchsorted(topo.base, np.arange(num_pdfs), side="right") - 1
    with open(j("ali_map.txt"), "w") as fh:
        fh.writelines(f"{k} {int(p)}\n" for k, p in enumerate(pdf_phone))
    ali_utils.main(["convert", j("ali.pkl"), j("ali_phones.pkl"), "--label_map", j("ali_map.txt")])
    os.makedirs(j("ali_copy"), exist_ok=True)
    with open(j("ali_copy", "ali.pkl"), "wb") as fh:
        pickle.dump(ali, fh)
    ali_utils.main(["combine", j("ali_all.pkl"), j("ali.pkl"), j("ali_copy", "ali.pkl")])
    with open(j("ali_phones.pkl"), "rb") as fh:
        phones = pickle.load(fh)
    with open(j("ali_all.pkl"), "rb") as fh:
        combined = pickle.load(fh)
    assert all(np.array_equal(phones[u], pdf_phone[ali[u]]) for u in ali)
    assert len(combined) == 2 * len(ali)

    am_s, steps = tm.get("align.am_step", (0.0, 0))
    steps = max(steps, 1)
    frames = sum(len(v) for v in ali.values())
    log(f"[align] timit_hybrid front-end, {len(utts)} utterances ({frames} frames), FDLP on "
        f"K1: {launches} launches, K1 vs plain on the path's lags max|err| {k1_err:.3e}; "
        f"lexicon {ALIGN_WORDS} words over {ALIGN_PHONES} phones, {num_pdfs} pdfs "
        f"({' '.join(ALIGN_FLAGS)})")
    log(f"[align] force_align.main (hidden 96, 1 layer, {ALIGN_EPOCHS} epochs, 2 iterations, "
        f"batch 8): "
        f"{t_align:.2f} s (profiled); host time {1e3 * am_s / steps:.2f} ms an AM step over "
        f"{steps} steps; DP launches {1e3 * tm.get('align.dp', (0.0,))[0] / n_batches:.2f} ms, "
        f"readback {1e3 * tm.get('align.readback', (0.0,))[0] / n_batches:.2f} ms and host "
        f"traceback {1e3 * tm.get('align.traceback', (0.0,))[0] / n_batches:.2f} ms a batch "
        f"of 8; frames changed per "
        f"iteration {[h['frames_changed_pct'] for h in history]}%, AM loss "
        f"{[round(h['am_loss'], 4) for h in history]}")
    log(f"[align] one batch's pseudo log-likelihoods, card vs CPU: labels identical, scores "
        f"within {worst:.3e} relative (limit 1e-5); ali_utils convert and combine done; phase "
        f"15 (c) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _scp_dict(path):
    with open(path) as f:
        return dict(line.strip().split(None, 1) for line in f if line.strip())


def enhance_phase(rng, dev, tmp, seed):
    """Phase 16. (a) Stage 0 of reverb_hybrid.json (:9-13) at full width:
    dsp/simulate.py::simulate_corpus makes ENH_UTTS utterances of 4-8 s at
    ENH_CHANNELS channels and SNR ENH_SNR_DB, laid out as a recipe's data
    dir (a multichannel wav.scp, clean_wav.scp, noise_wav.scp); then, as
    recipes/run_corpus.py:470-513 runs them, maybe_mask_model trains the
    BLSTM mask net (ENH_MASK_EPOCHS epoch), run_enhancement enhances every
    utterance (WPE -> mask net -> GEV + BAN + phase correction -> iSTFT)
    and se_scores scores them with all eight metrics, each a number. ms a
    mask-net step, ms an utterance by part, the real-time factor and the
    device's busy share; card against CPU on the shortest utterance (WPE,
    mask-net masks, the beamformed STFT up to one global phase, the first
    step's loss); one utterance at chime4_hybrid.json:9-13 (6 channels, no
    WPE: the even-count median on the card). (b) compute_fdlp_spectrogram
    at wsj_fdlp_e2e's front-end over (a)'s enhanced wavs with --add_noise
    <seeded noise>,AUG_SNR --add_reverb small_room, run from a directory
    holding the seeded noises/ and RIR/ wavs: K1 counted and held to its
    plain version on the path's lags, features card against CPU on
    AUG_CPU_UTTS utterances. Returns K1's launches over (b)'s featgen."""
    import argparse

    from scipy.io.wavfile import write as wav_write

    from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram
    from speech_recognition_tools_tpu_torch.cli.common import RIR_FILES, load_signals
    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_lags
    from speech_recognition_tools_tpu_torch.dsp.simulate import simulate_corpus, synth_rir
    from speech_recognition_tools_tpu_torch.enhance import pipeline
    from speech_recognition_tools_tpu_torch.enhance.mask_model import (
        BLSTMMaskEstimator,
        estimate_masks,
        train_mask_estimator,
    )
    from speech_recognition_tools_tpu_torch.enhance.stft import istft, stft
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    sr = 16000

    def recipe_enhancement(name):
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes",
                               "configs", name)) as f:
            return json.load(f)["enhancement"]

    enh = recipe_enhancement("reverb_hybrid.json")
    enh["beamform"]["mask_epochs"] = ENH_MASK_EPOCHS
    enh_c4 = recipe_enhancement("chime4_hybrid.json")
    bf = enh["beamform"]
    assert int(bf["nch"]) == ENH_CHANNELS and not enh_c4.get("wpe"), (enh, enh_c4)
    size, shift = int(bf.get("size", 1024)), int(bf.get("shift", 256))

    # ---- the corpus, as a recipe's data dir ----
    x, lens = speechlike_batch(rng, ENH_UTTS, *ENH_SECONDS)
    clean = [(f"enh{b}", x[b, : lens[b]] / 32768.0) for b in range(ENH_UTTS)]
    t0 = time.perf_counter()
    simulate_corpus(clean, j("enh_sim"), fs=sr, n_channels=ENH_CHANNELS, snr_db=ENH_SNR_DB,
                    seed=seed, device=dev)
    t_sim = time.perf_counter() - t0
    data = j("enh_data")
    os.makedirs(data)
    chans = [_scp_dict(j("enh_sim", f"wav_ch{c}.scp")) for c in range(ENH_CHANNELS)]
    with open(os.path.join(data, "wav.scp"), "w") as f:
        f.writelines(f"{u} {' '.join(ch[u] for ch in chans)}\n" for u in chans[0])
    for src, dst in (("clean.scp", "clean_wav.scp"), ("noise.scp", "noise_wav.scp")):
        with open(j("enh_sim", src)) as fi, open(os.path.join(data, dst), "w") as fo:
            fo.write(fi.read())
    audio_s = float(lens.sum()) / sr

    # ---- stage 0: the mask net, the enhancement, the scores ----
    logs = []
    exp = j("enh_exp")
    os.makedirs(exp)
    t0 = time.perf_counter()
    mask_fn = pipeline.maybe_mask_model(enh, exp, train_dir=data, srate=sr, log=logs.append,
                                        device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    assert mask_fn is not None and any("trained on" in s for s in logs), logs
    assert os.path.exists(os.path.join(exp, "mask_model", "state.msgpack"))
    model = mask_fn.model
    t0 = time.perf_counter()
    out_scp = pipeline.run_enhancement(os.path.join(data, "wav.scp"), j("enh_out"), enh, sr,
                                       mask_fn=mask_fn, log=logs.append, device=dev)
    t_enh = time.perf_counter() - t0
    enhanced = pipeline.read_multichannel_scp(out_scp)
    assert list(enhanced) == [u for u, _ in clean]
    t0 = time.perf_counter()
    scores = pipeline.se_scores(out_scp, os.path.join(data, "clean_wav.scp"), ENH_METRICS, sr,
                                log=logs.append)
    t_scores = time.perf_counter() - t0
    assert all(isinstance(scores[m], float) and np.isfinite(scores[m]) for m in ENH_METRICS), (
        scores, logs)
    for line in logs:
        log(f"[enh] {line}")

    # ---- ms an utterance by part (a second pass, synchronised) ----
    mc = pipeline.read_multichannel_scp(os.path.join(data, "wav.scp"))
    sigs = {u: pipeline.load_channels(e, sr).astype(np.float32) for u, e in mc.items()}
    parts = []
    for u, sig in sigs.items():
        xs = torch.as_tensor(sig, device=dev)
        torch.cuda.synchronize()
        t = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        xw = pipeline.maybe_wpe(xs, enh)
        mark()
        X = stft(xw, size=size, shift=shift)
        sm, nm = mask_fn(X.abs())
        mark()
        Yf = pipeline.beamform_stft(X, enh, sm, nm)
        mark()
        y = istft(Yf.T, size=size, shift=shift)[: xs.shape[-1]]
        mark()
        assert torch.isfinite(y).all(), u
        parts.append(np.diff(t) * 1e3 / (sig.shape[1] / sr))  # ms per audio s
    parts = np.median(np.asarray(parts), axis=0)
    short = min(sigs, key=lambda u: sigs[u].shape[1])
    sig = sigs[short]
    prof = device_breakdown("enhance_utterance, reverb_hybrid stage 0, one utterance of "
                            f"{sig.shape[1] / sr:.2f} s",
                            lambda: pipeline.enhance_utterance(sig, enh, mask_fn, device=dev))
    busy = f"{100 * prof[1] / prof[0]:.1f}%" if prof else "not measured"

    # ---- the mask net: ms a step, first-step loss card against CPU ----
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    cl_path = _scp_dict(os.path.join(data, "clean_wav.scp"))[short]
    nz_path = _scp_dict(os.path.join(data, "noise_wav.scp"))[short]
    c_sig = pipeline.load_channels([cl_path], sr)[0]
    n_sig = pipeline.load_channels([nz_path], sr)[0]
    losses, step_s = [], []
    for d, n_ep in ((str(dev), 3), ("cpu", 1)):  # three timed steps on the card
        ex = (stft(c_sig, size, shift, device=d), stft(n_sig, size, shift, device=d))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_mask_estimator([ex], model.bins, hidden=model.hidden, epochs=n_ep,
                                           init_state=init, device=d)[2])
        torch.cuda.synchronize()
        step_s.append((time.perf_counter() - t0) / n_ep)
    losses = {str(dev): losses[0], "cpu": losses[1]}
    t_step = step_s[0]
    loss_rel = _rel(losses[str(dev)][0], losses["cpu"][0])
    assert np.isfinite(losses["cpu"][0]) and loss_rel <= ENH_LOSS_REL, losses

    # ---- card against CPU on the shortest utterance ----
    xw_d = pipeline.maybe_wpe(torch.as_tensor(sig, device=dev), enh).cpu()
    xw_c = pipeline.maybe_wpe(torch.as_tensor(sig), enh)
    assert torch.isfinite(xw_d).all()
    wpe_rel = ((xw_d - xw_c).abs().max() / xw_c.abs().max()).item()
    assert wpe_rel <= ENH_WPE_REL, wpe_rel
    X_c = stft(xw_c, size, shift)
    cpu_model = BLSTMMaskEstimator(model.bins, model.hidden, device="cpu")
    cpu_model.load_state_dict(init)
    cpu_model.eval()
    m_c = estimate_masks(cpu_model, X_c.abs())
    m_d = estimate_masks(model, X_c.abs().to(dev))
    mask_err = max((a.cpu() - b).abs().max().item() for a, b in zip(m_d, m_c))
    assert mask_err <= ENH_MASK_ATOL, mask_err
    # the beamformer on the same STFT and masks, card against CPU, in
    # complex128 (asserted) and in the pipeline's complex64 (logged): a mask
    # net trained for one epoch gives speech and noise masks near 0.5, so
    # the two PSDs nearly agree and the generalised eigenvectors are
    # ill-conditioned; complex64 eigh on two devices picks other vectors in
    # such bins, and the phase correction carries each difference on to the
    # bins above it
    bf_rel = {}
    for dt in (torch.complex128, torch.complex64):
        X_t, m_t = X_c.to(dt), [m.to(dt.to_real()) for m in m_c]
        Y_c = pipeline.beamform_stft(X_t, enh, *m_t).numpy()
        Y_d = pipeline.beamform_stft(X_t.to(dev), enh, *(m.to(dev) for m in m_t)).cpu().numpy()
        assert np.isfinite(Y_d).all(), dt
        bf_rel[dt] = _phase_aligned_rel(Y_d, Y_c)
    assert bf_rel[torch.complex128] <= ENH_BF_REL, bf_rel

    # ---- one utterance at chime4_hybrid's stage 0: 6 channels, no WPE ----
    six = sig[:6]
    y4 = pipeline.enhance_utterance(six, enh_c4, mask_fn, device=dev)
    assert y4.shape == (six.shape[1],) and np.isfinite(y4).all()
    mag6 = stft(torch.as_tensor(six, device=dev), size, shift).abs()
    with torch.no_grad():
        per_ch = model(torch.stack([m / m.mean().clamp_min(1e-12) for m in mag6]),
                       torch.full((6,), mag6.shape[1], device=dev))[0]
    median6 = np.median(per_ch.cpu().numpy(), axis=0)  # numpy's even-count rule
    even_err = np.abs(estimate_masks(model, mag6)[0].cpu().numpy() - median6).max()
    assert even_err <= 1e-6, even_err
    # its beamformer card against CPU in complex128 on the card's masks
    X6 = stft(torch.as_tensor(six, dtype=torch.float64), size, shift)
    m6 = [m.double().cpu() for m in estimate_masks(model, mag6)]
    Y4_c = pipeline.beamform_stft(X6, enh_c4, *m6).numpy()
    Y4_d = pipeline.beamform_stft(X6.to(dev), enh_c4, *(m.to(dev) for m in m6)).cpu().numpy()
    c4_rel = _phase_aligned_rel(Y4_d, Y4_c)
    assert c4_rel <= ENH_BF_REL, c4_rel
    t_a = time.perf_counter() - t_phase

    # ---- (b) augmented featgen of the enhanced wavs ----
    aug = j("enh_aug")
    os.makedirs(os.path.join(aug, "noises"))
    os.makedirs(os.path.join(aug, "RIR"))
    # a float32 noise wav: an int16 one's energy wraps in the CLIs'
    # np.mean(ns**2), in both packages (ROADMAP Queue 3)
    noise = (rng.randn(20 * sr) * 3000).astype(np.float32)
    wav_write(os.path.join(aug, "noises", "enhnoise.wav"), sr, noise)
    rir = synth_rir(2, sr, 0.3, generator=torch.Generator().manual_seed(seed), device="cpu")
    wav_write(os.path.join(aug, RIR_FILES["small_room"]), sr,
              (rir.numpy().T * 16000).astype(np.int16))
    flags = [*WSJ_FDLP_FLAGS, "--add_noise", f"enhnoise,{AUG_SNR}", "--add_reverb",
             "small_room", "--write_utt2num_frames"]
    with open(out_scp) as f:
        head = f.readlines()[:AUG_CPU_UTTS]
    with open(j("enh_out_head.scp"), "w") as f:
        f.writelines(head)
    cwd = os.getcwd()
    os.chdir(aug)
    try:
        np.random.seed(seed)
        lpc_cepstra.launches = 0
        t0 = time.perf_counter()
        compute_fdlp_spectrogram.main([out_scp, j("aug_card"), *flags, "--device", str(dev)])
        torch.cuda.synchronize()
        t_aug = time.perf_counter() - t0
        launches = lpc_cepstra.launches
        np.random.seed(seed)
        t0 = time.perf_counter()
        compute_fdlp_spectrogram.main([j("enh_out_head.scp"), j("aug_cpu"), *flags,
                                       "--device", "cpu"])
        t_aug_cpu = time.perf_counter() - t0
        np.random.seed(seed)
        signals = load_signals(argparse.Namespace(scp=out_scp, add_noise=f"enhnoise,{AUG_SNR}",
                                                  add_reverb="small_room"), sr)
    finally:
        os.chdir(cwd)
    assert launches > 0, "the augmented featgen did not launch K1"
    card = dict(read_ark(j("aug_card.ark")))
    cpu = dict(read_ark(j("aug_cpu.ark")))
    assert sorted(card) == sorted(u for u, _ in clean) and len(cpu) == AUG_CPU_UTTS
    assert all(np.isfinite(v).all() and v.shape[1] == 80 for v in card.values())
    feat_err = max(np.abs(card[k] - cpu[k]).max() for k in cpu)
    for k in cpu:
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-3, atol=2e-3)
    e2e = FdlpConfig(nfilters=80, order=150, fduration=1.5, coeff_num=100, coeff_range="1,100")
    nmax = max(len(s) for _, s in signals)
    xb = np.zeros((len(signals), nmax), np.float32)
    for b, (_, s) in enumerate(signals):
        xb[b, : len(s)] = s
    lb = np.asarray([len(s) for _, s in signals], np.int32)
    r, _ = fdlp_lags(xb, lb, e2e, device=dev)
    # order-150 FDLP lags: phase 2's limits for them
    k1_err = _k1_on_path("augmented featgen of the enhanced wavs", r.reshape(-1, r.shape[-1]),
                         e2e.order, e2e.coeff_num, NEAR_PERIODIC_TOL, NEAR_PERIODIC_REL)

    log(f"[enh] reverb_hybrid stage 0: {ENH_UTTS} utterances of {ENH_SECONDS[0]:g}-"
        f"{ENH_SECONDS[1]:g} s ({audio_s:.1f} s audio) x {ENH_CHANNELS} channels, SNR "
        f"{ENH_SNR_DB:g} dB; WPE {enh['wpe']}; beamform {bf}")
    log(f"[enh] simulate_corpus {t_sim:.2f} s; maybe_mask_model (STFT pairs + {ENH_UTTS} steps "
        f"x {ENH_MASK_EPOCHS} epoch) {t_train:.2f} s; a mask-net step (B = 1, "
        f"{sig.shape[1] / sr:.2f} s, hidden {model.hidden}, {model.bins} bins) "
        f"{t_step * 1e3:.1f} ms; first-step loss card {losses[str(dev)][0]:.6f}, rel to cpu "
        f"{loss_rel:.2e} (limit {ENH_LOSS_REL})")
    log(f"[enh] run_enhancement {t_enh:.2f} s = {audio_s / t_enh:.2f}x real time "
        f"(RTF {t_enh / audio_s:.4f}); ms per audio s by part (median over utterances): WPE "
        f"{parts[0]:.2f}, STFT + masks {parts[1]:.2f}, beamforming {parts[2]:.2f}, synthesis "
        f"{parts[3]:.2f}; device busy {busy}")
    log(f"[enh] se_scores {t_scores:.2f} s: " + ", ".join(
        f"{m} {scores[m]:.4f}" for m in ENH_METRICS))
    log(f"[enh] card vs cpu on {short} ({sig.shape[1] / sr:.2f} s): WPE {wpe_rel:.2e} of the "
        f"peak (limit {ENH_WPE_REL}); mask-net masks "
        f"{mask_err:.2e} (limit {ENH_MASK_ATOL}); beamformed STFT after one global phase "
        f"{bf_rel[torch.complex128]:.2e} of the peak in complex128 (limit {ENH_BF_REL}), "
        f"{bf_rel[torch.complex64]:.2e} in complex64 (not held: ill-conditioned bins)")
    log(f"[enh] chime4_hybrid stage 0 (6 channels, no WPE): even-count median on the card "
        f"against numpy's {even_err:.1e}; beamformed STFT card vs cpu in complex128 "
        f"{c4_rel:.2e}; (a) took "
        f"{t_a:.1f} s")
    log(f"[enh] (b) compute_fdlp_spectrogram wsj_fdlp_e2e --add_noise enhnoise,{AUG_SNR} "
        f"--add_reverb small_room over the {ENH_UTTS} enhanced wavs: {t_aug:.2f} s on the card "
        f"({audio_s / t_aug:.1f}x real time), K1 launches {launches}, max|kernel - plain| "
        f"{k1_err:.3e}; features card vs cpu on {AUG_CPU_UTTS} utterances {feat_err:.3e} "
        f"(rtol 1e-3, atol 2e-3; CPU {t_aug_cpu:.2f} s); phase 16 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 17


def _captured(fn, *args):
    """fn(*args) with its standard output kept in a buffer: returns (result,
    text). On a failure the buffer's tail goes to stderr before the
    exception propagates."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
    except BaseException:
        sys.stderr.write(buf.getvalue()[-6000:])
        raise
    return out, buf.getvalue()


class _K1Recorder:
    """Within `with`, dsp.fdlp's K1 entry records each launch's (rows,
    order, lim) and keeps a copy of the first launch's lags, so that K1 can
    be held to its plain version on a path's own lags afterwards. The
    launches are still counted by the wrapper itself."""

    def __enter__(self):
        from speech_recognition_tools_tpu_torch.dsp import fdlp

        self.mod, self.orig = fdlp, fdlp.lpc_cepstra
        self.shapes, self.lags = [], None

        def recorded(r, order, lim, *a, **kw):
            self.shapes.append((r.shape[0], order, lim))
            if self.lags is None:
                self.lags, self.order, self.lim = r.detach().clone(), order, lim
            return self.orig(r, order, lim, *a, **kw)

        fdlp.lpc_cepstra = recorded
        return self

    def __exit__(self, *exc):
        self.mod.lpc_cepstra = self.orig

    def summary(self):
        rows = {}
        for P, order, lim in self.shapes:
            rows.setdefault((order, lim), []).append(P)
        return "; ".join(f"order {o} lim {m}: {len(ps)} launches of {min(ps)}-{max(ps)} rows "
                         f"({sum(ps)} in all)" for (o, m), ps in rows.items())


def _run_recipe(argv, carry):
    """run_corpus.main(argv) on the card with its output captured; `carry`
    gains (stage, bytes allocated on the card at the stage's start) for
    each stage: after the profiler's collection and with cuBLAS's
    workspaces freed (the caching allocator holds one per handle, and the
    backward pass's thread opens its own), so that what remains is what
    the earlier stages left alive."""
    from speech_recognition_tools_tpu_torch.recipes import run_corpus

    orig = run_corpus.StageProfiler.mark

    def mark(prof, label):
        orig(prof, label)
        torch._C._cuda_clearCublasWorkspaces()
        carry.append((label, torch.cuda.memory_allocated()))

    run_corpus.StageProfiler.mark = mark
    try:
        return _captured(run_corpus.main, argv)
    finally:
        run_corpus.StageProfiler.mark = orig


def _log_profile(tag, exp, base, carry):
    """Each stage's seconds, peak device memory (stage_profile.json) and the
    memory it started with beyond `base`: within RECIPE_CARRY_BYTES, and
    from the second stage on at most RECIPE_GROWTH_BYTES above the second
    stage's start (the first stage leaves the featgen's cached constants and
    the libraries' state; no later stage may keep an earlier one's models
    alive)."""
    with open(os.path.join(exp, "stage_profile.json")) as f:
        prof = json.load(f)
    starts = dict(carry)
    second = starts[prof["stages"][1]["stage"]]
    for i, st in enumerate(prof["stages"]):
        mem = st["device_memory"]
        start = starts[st["stage"]]
        log(f"[{tag}] stage {st['stage']}: {st['seconds']:.2f} s, peak "
            f"{mem['peak_bytes_in_use'] / 2**30:.3f} GiB ({base / 2**30:.3f} of it held "
            f"before the run), started with {(start - base) / 2**20:.1f} MiB beyond that")
        assert start - base <= RECIPE_CARRY_BYTES, (st["stage"], start - base)
        assert i < 1 or start - second <= RECIPE_GROWTH_BYTES, (st["stage"], start - second)
    return prof


def recipe_phase(dev, tmp, seed):
    """Phase 17: the port's recipe drivers on the card. (a) run_corpus at
    recipes/configs/wsj_fdlp_e2e.json, stages 1-5 with --profile_stages,
    on a make_synth_corpus corpus (RECIPE_CORPUS, --seed): FDLP (K1,
    counted and held to its plain version on the stage's lags) -> dict,
    egs, CMVN -> the 1 x 1000 RNNLM -> the 12/6 transformer -> beam 10 with
    the LM, --jit_decode at batch 8 -> RESULTS; each stage's seconds and
    peak memory; then --stage 5 again on the same expdir: the same
    hypotheses, no file of stages 1-4 rewritten. (b) run_corpus at
    timit_hybrid.json, stages 1-6, on the same corpus (27 classes from its
    ali.pkl, the lexicon's WFST decode, the 2 + 2 x 512 pm_ae); stage 5 on
    a copy of the expdir with --device cpu: log-likelihoods within
    RECIPE_LL_REL of their scale, hypotheses by phase 9's rule. (c) the
    demo recipe at its defaults: Viterbi and argmax FER. (d) the reverb
    demo (REVERB_DEMO_ARGS): SE scores of noisy and enhanced audio, the
    hypothesis file. (e) prefetch_to_device on the card and babysit around
    a command that crashes once. Returns K1's launches by path."""
    import pickle
    import shutil

    from speech_recognition_tools_tpu_torch.cli import babysit
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.io.prefetch import prefetch_to_device
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.recipes import (
        demo,
        make_synth_corpus,
        reverb_demo,
        run_corpus,
    )

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    config = lambda name: os.path.join(  # noqa: E731
        os.path.dirname(os.path.abspath(__file__)), "recipes", "configs", name)
    launches = {}

    # ---- the corpus ----
    corpus = j("rc_corpus")
    t0 = time.perf_counter()
    _captured(make_synth_corpus.main, ["--out", corpus, "--seed", str(seed)] + RECIPE_CORPUS)
    t_corpus = time.perf_counter() - t0
    sizes = {}
    for name in ("train", "dev", "test"):
        with open(os.path.join(corpus, name, "ali.pkl"), "rb") as f:
            ali = pickle.load(f)
        sizes[name] = (len(ali), sum(len(v) for v in ali.values()) / 100.0)
    log(f"[recipe] make_synth_corpus --seed {seed} {' '.join(RECIPE_CORPUS)}: " + ", ".join(
        f"{k} {n} utterances ({s:.1f} s)" for k, (n, s) in sizes.items())
        + f" in {t_corpus:.1f} s")

    # ---- (a) the e2e branch at wsj_fdlp_e2e, stages 1-5 ----
    e2e_exp = j("rc_e2e")
    e2e_argv = ["--config", config("wsj_fdlp_e2e.json"), "--data", corpus, "--expdir", e2e_exp,
                "--device", str(dev)]
    e2e_argv += [a for c in RECIPE_E2E_CUTS for a in ("--set", c)]
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    base, carry = torch.cuda.memory_allocated(), []
    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    with _K1Recorder() as rec:
        results, out = _run_recipe(e2e_argv + ["--stage", "1", "--stop_stage", "5",
                                               "--profile_stages"], carry)
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t0
    launches["recipe_e2e"] = lpc_cepstra.launches
    assert launches["recipe_e2e"] > 0, "the e2e recipe did not launch K1"
    assert len(results) == 1 and results[0][0] == "test" and np.isfinite(results[0][1])
    _log_profile("recipe-e2e", e2e_exp, base, carry)
    with open(os.path.join(e2e_exp, "RESULTS")) as f:
        wer_line = f.read().strip()
    log(f"[recipe-e2e] wsj_fdlp_e2e stages 1-5 with --set {' '.join(RECIPE_E2E_CUTS)}: "
        f"{t_e2e:.1f} s; K1 on stage 1: {rec.summary()}; {wer_line}")
    k1_e2e = _k1_on_path("recipe_e2e stage 1", rec.lags, rec.order, rec.lim,
                         RECIPE_K1_TOL, RECIPE_K1_REL)
    del rec
    with open(os.path.join(e2e_exp, "hyp_test.txt")) as f:
        hyps = f.read()
    assert len(hyps.splitlines()) == sizes["test"][0], hyps
    kept = {}
    for root, _, files in os.walk(e2e_exp):
        for f in files:
            if f not in ("hyp_test.txt", "RESULTS", "stage_profile.json"):
                kept[os.path.join(root, f)] = os.stat(os.path.join(root, f)).st_mtime_ns
    t0 = time.perf_counter()
    _captured(run_corpus.main, e2e_argv + ["--stage", "5", "--stop_stage", "5"])
    t_resume = time.perf_counter() - t0
    with open(os.path.join(e2e_exp, "hyp_test.txt")) as f:
        assert f.read() == hyps, "--stage 5 again gave other hypotheses"
    rewritten = [p for p, m in kept.items() if os.stat(p).st_mtime_ns != m]
    assert not rewritten, rewritten
    log(f"[recipe-e2e] --stage 5 again on the same expdir ({t_resume:.1f} s): hypotheses "
        f"identical, none of {len(kept)} files of stages 1-4 rewritten; sample "
        f"{hyps.splitlines()[0][:70]!r}")

    # ---- (b) the hybrid branch at timit_hybrid, stages 1-6 ----
    hyb_exp, hyb_cpu = j("rc_hyb"), j("rc_hyb_cpu")
    hyb_argv = ["--config", config("timit_hybrid.json"), "--data", corpus]
    cuts = [a for c in RECIPE_HYB_CUTS for a in ("--set", c)]
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    base, carry = torch.cuda.memory_allocated(), []
    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    with _K1Recorder() as rec:
        results, out = _run_recipe(hyb_argv + ["--expdir", hyb_exp, "--stage", "1",
                                               "--stop_stage", "6", "--profile_stages",
                                               "--device", str(dev)] + cuts, carry)
    torch.cuda.synchronize()
    t_hyb = time.perf_counter() - t0
    launches["recipe_hybrid"] = lpc_cepstra.launches
    assert launches["recipe_hybrid"] > 0, "the hybrid recipe did not launch K1"
    assert len(results) == 1 and np.isfinite(results[0][1])
    _log_profile("recipe-hybrid", hyb_exp, base, carry)
    with open(os.path.join(hyb_exp, "RESULTS")) as f:
        wer_line = f.read().strip()
    with open(os.path.join(hyb_exp, "pm.score"), "rb") as f:
        pm = pickle.load(f)
    assert len(pm) == sizes["test"][0] and all(np.isfinite(v).all() for v in pm.values()), pm
    log(f"[recipe-hybrid] timit_hybrid stages 1-6 with --set {' '.join(RECIPE_HYB_CUTS)}: "
        f"{t_hyb:.1f} s; K1 on stage 1: {rec.summary()}; {wer_line}; {len(pm)} PM scores")
    k1_hyb = _k1_on_path("recipe_hybrid stage 1", rec.lags, rec.order, rec.lim,
                         RECIPE_K1_TOL, RECIPE_K1_REL)
    del rec
    shutil.copytree(hyb_exp, hyb_cpu)
    t0 = time.perf_counter()
    _captured(run_corpus.main, hyb_argv + ["--expdir", hyb_cpu, "--stage", "5",
                                           "--stop_stage", "5", "--device", "cpu"] + cuts)
    t_cpu = time.perf_counter() - t0
    ll_g = dict(read_ark(os.path.join(hyb_exp, "loglikes_test.ark")))
    ll_c = dict(read_ark(os.path.join(hyb_cpu, "loglikes_test.ark")))
    keys = list(ll_c)
    assert list(ll_g) == keys and all(np.isfinite(v).all() for v in ll_g.values())
    ll_rel = max(float(np.abs(ll_g[k] - ll_c[k]).max() / np.abs(ll_c[k]).max()) for k in keys)
    assert ll_rel <= RECIPE_LL_REL, ll_rel
    _, differ = _wfst_hyps_agree("recipe-hybrid", os.path.join(hyb_exp, "graph"),
                                 os.path.join(hyb_exp, "hyp_test.txt"),
                                 os.path.join(hyb_cpu, "hyp_test.txt"), ll_g, ll_c, keys)
    log(f"[recipe-hybrid] stage 5 card vs --device cpu ({t_cpu:.1f} s): log-likelihoods "
        f"{ll_rel:.2e} of their scale (limit {RECIPE_LL_REL}); WFST hypotheses identical "
        f"{len(keys) - len(differ)} of {len(keys)}")

    # ---- (c) the demo recipe at its defaults ----
    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    _, out = _captured(demo.main, ["--expdir", j("demo"), "--device", str(dev)])
    t_demo = time.perf_counter() - t0
    launches["demo"] = lpc_cepstra.launches
    assert launches["demo"] > 0, "the demo did not launch K1"
    fer = [ln for ln in out.splitlines() if "FER" in ln]
    assert len(fer) == 2 and all(np.isfinite(float(ln.split()[-1].rstrip("%"))) for ln in fer)
    wer = [ln.strip() for ln in out.splitlines() if "WER" in ln]
    log(f"[demo] recipes/demo.py at its defaults (8 utterances, stages 0-6): {t_demo:.1f} s; "
        f"{'; '.join(fer)}; {'; '.join(wer)}; K1 launches {launches['demo']}")

    # ---- (d) the reverb demo ----
    rv = j("reverb_demo")
    lpc_cepstra.launches = 0
    t0 = time.perf_counter()
    _captured(reverb_demo.main, ["--expdir", rv, "--device", str(dev)] + REVERB_DEMO_ARGS)
    t_rv = time.perf_counter() - t0
    launches["reverb_demo"] = lpc_cepstra.launches
    assert launches["reverb_demo"] > 0, "the reverb demo's stage 4 did not launch K1"
    with open(os.path.join(rv, "se_scores.json")) as f:
        scores = json.load(f)
    for label in ("noisy", "enhanced"):
        for k, v in scores[label].items():
            assert (v is None and k == "pesq") or np.isfinite(v), (label, k, v)
    with open(os.path.join(rv, "hyp.text")) as f:
        hyp_rv = f.read().strip()
    assert hyp_rv, "the reverb demo wrote no hypothesis"
    log(f"[reverb-demo] recipes/reverb_demo.py {' '.join(REVERB_DEMO_ARGS)}: {t_rv:.1f} s; "
        f"K1 launches at stage 4 {launches['reverb_demo']}; " + "; ".join(
            f"{label} " + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} none"
                                    for k, v in scores[label].items())
            for label in ("noisy", "enhanced")) + f"; hyp.text {hyp_rv[:80]!r}")

    # ---- (e) prefetch_to_device on the card, babysit ----
    rng = np.random.RandomState(seed)
    host = [{"feats": rng.randn(32, 400, 80).astype(np.float32),
             "lens": rng.randint(100, 401, 32)} for _ in range(6)]
    w = torch.randn(80, 512, device=dev)
    n = 0
    t0 = time.perf_counter()
    for g, h in zip(prefetch_to_device(iter(host), size=2, device=dev), host, strict=True):
        assert g["feats"].device.type == g["lens"].device.type == dev.type
        (g["feats"] @ w).relu_().sum().item()  # consume on the current stream
        assert torch.equal(g["feats"].cpu(), torch.from_numpy(h["feats"]))
        assert torch.equal(g["lens"].cpu(), torch.from_numpy(h["lens"]))
        n += 1
    t_pf = time.perf_counter() - t0

    def broken():
        yield host[0]
        raise ValueError("producer failed")

    it = prefetch_to_device(broken(), device=dev)
    assert next(it)["feats"].device.type == dev.type
    try:
        next(it)
        raise AssertionError("the producer's error did not arrive")
    except ValueError as e:
        assert "producer failed" in str(e)
    script, count = j("crash_once.py"), j("crash_once.count")
    with open(script, "w") as f:
        f.write("import os, sys\n"
                f"p = {count!r}\n"
                "n = int(open(p).read()) + 1 if os.path.exists(p) else 1\n"
                "open(p, 'w').write(str(n))\n"
                "sys.exit(3 if n == 1 else 0)\n")
    rc = babysit.babysit([sys.executable, script], max_restarts=3, min_uptime=0.0, backoff=0.0)
    with open(count) as f:
        runs = int(f.read())
    assert rc == 0 and runs == 2, (rc, runs)
    log(f"[host] prefetch_to_device: {n} batches of (32, 400, 80) float32 in order and equal "
        f"to the host's ({t_pf * 1e3 / n:.1f} ms a batch with a GEMM each); the producer's "
        f"ValueError reached the consumer; babysit: a command that crashed once (rc 3) "
        f"then succeeded, rc {rc} after {runs} runs")
    log(f"[recipe] K1 on the recipe paths: max|kernel - plain| {max(k1_e2e, k1_hyb):.3e}; "
        f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 18

# phase 18: the parallel layer. Worlds of local ranks on this one card
# (gloo, exchanges through host memory) measure correctness and overhead,
# not scaling; a 1-rank NCCL world proves the NCCL path.
PAR_SEQ_UTTS, PAR_SEQ_SECONDS = 4, 60.0
PAR_RING_UTTS, PAR_RING_SECONDS = 4, (20.0, 30.0)
PAR_RING_DECODE = ["--beam_size", "4", "--max_len", "15"]
PAR_LOSS_REL, PAR_GNORM_REL = 1e-5, 1e-4  # phase 7's card-vs-CPU step limits
PAR_FEAT_TOL = dict(rtol=1e-3, atol=2e-3)  # phase 3's
# (a)'s batches: one length bucket over phase 3's 6-10 s utterances, so
# that every batch pads to 10 s and the one-process reference, at half the
# batch size, runs each rank's rows of a data-parallel batch as a batch of
# its own. Featgen is batch-dependent in float32 (an utterance's features
# in a batch of 32 and in its half of it differ by up to 3.7e-3 at --seed
# 0 on the H100, its lags by 7e-7 of their scale), and (a) holds the
# data-parallel path, not that
PAR_FEAT_BUCKET = ["--bucket_seconds", "10"]
PAR_RING_ATOL = 1e-4
# each parallel run's parameter change over its 2 steps against one
# process's: over the whole model |error| <= PAR_UPDATE_REL |change|, and
# element by element |error| <= PAR_UPDATE_REL |change| + ulp, the float32
# spacing at the weight (the Noam rate is ~1e-7 there, so a LayerNorm scale
# near 1 moves ~4 ulps, and two runs that agree to far less than an ulp may
# round an element to neighbours) in all but PAR_UPDATE_SHARE of each
# tensor's elements. Adam's first steps move an element by ~the rate
# whatever the size of its gradient, so an element whose gradient sums to
# rounding noise moves by noise in each run; a missing, doubled, stale or
# mis-sharded update misses on all, or half, of a tensor's elements. Adam's
# moments against one process's, tensor by tensor, relative to the tensor's
# norm (phase 7's gradient bound is 1e-4; their sums run in another order).
# The attention key biases are left out: softmax is shift-invariant, so
# their gradient is 0 in exact arithmetic and rounding noise in each run
PAR_UPDATE_REL = 1e-2
PAR_UPDATE_SHARE = 0.05
PAR_MOMENT_REL = 1e-3
PAR_TIMEOUT_S = 240.0  # a world ~4x its measured time; a hung rank fails the phase
PAR_E2E_MODES = {"dp": ["--data_parallel"], "tp": ["--tensor_parallel", "2"],
                 "pp": ["--pipeline_parallel", "2", "--pp_microbatches", "4"]}


class _Recorder:
    """Per-process records of a training CLI's steps (the first-step loss
    and gradient norm) and of the time spent in the collectives' exchanges,
    by wrapping the module functions the CLIs call."""

    def __init__(self):
        from speech_recognition_tools_tpu_torch.models import transformer_asr
        from speech_recognition_tools_tpu_torch.parallel import collectives
        from speech_recognition_tools_tpu_torch.train import optim, trainer

        self.losses, self.gnorms, self.exchange_s, self.step_ends = [], [], 0.0, []
        joint = transformer_asr.joint_loss
        apply_adam, apply_rule = optim.ClipAdam.apply, optim.ClipRule.apply
        train_step = trainer.Trainer.train_step

        def rec_joint(*a, **k):
            out = joint(*a, **k)
            if torch.is_grad_enabled():
                self.losses.append(float(out[0].detach()))
            return out

        def rec_apply(orig):
            def apply(opt, *a, **k):
                state, gnorm = orig(opt, *a, **k)
                self.gnorms.append(float(gnorm))
                self.step_ends.append(time.perf_counter())
                return state, gnorm
            return apply

        def rec_step(tr, state, batch):
            loss, aux, gnorm = train_step(tr, state, batch)
            self.losses.append(float(loss))
            return loss, aux, gnorm

        def timed(fn):
            def w(*a, **k):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.exchange_s += time.perf_counter() - t
                return out
            return w

        transformer_asr.joint_loss = rec_joint
        optim.ClipAdam.apply = rec_apply(apply_adam)
        optim.ClipRule.apply = rec_apply(apply_rule)
        trainer.Trainer.train_step = rec_step
        for name in ("_exchange", "all_reduce", "all_gather_list"):
            setattr(collectives, name, timed(getattr(collectives, name)))

    def reset(self):
        self.losses, self.gnorms, self.exchange_s, self.step_ends = [], [], 0.0, []

    def run(self, fn, *args):
        """fn(*args) timed, K1 counted: (seconds, exchange share, K1
        launches, result)."""
        from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

        self.reset()
        lpc_cepstra.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        return t, self.exchange_s / t, lpc_cepstra.launches, out


def _update_check(init, one, pay):
    """A training run's checkpoint payload `pay` against one process's
    `one`, both after the same steps from the payload `init`, the key
    biases left out: (the worst tensor's share of elements whose change
    misses one process's by more than PAR_UPDATE_REL of it plus an ulp, and
    its name; the parameter change's error relative to its norm over the
    whole model; for mu and nu the worst tensor's |a - b| / |b|)."""
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax

    def sd(tree):
        return {k: v.double() for k, v in transformer_asr_from_jax(tree).items()
                if not k.endswith("key.bias")}

    one32 = transformer_asr_from_jax(one["params"])
    p0, p1, p = sd(init["params"]), sd(one["params"]), sd(pay["params"])
    assert set(p) == set(p1) == set(p0)
    worst, err2, ref2 = (-1.0, ""), 0.0, 0.0
    for k in p0:
        err = (p[k] - p1[k]).abs()  # |(p - p0) - (p1 - p0)|
        change = (p1[k] - p0[k]).abs()
        ulp = (torch.nextafter(one32[k], torch.full_like(one32[k], float("inf")))
               - one32[k]).double()
        worst = max(worst, ((err > PAR_UPDATE_REL * change + ulp).double().mean().item(), k))
        err2, ref2 = err2 + err.square().sum().item(), ref2 + change.square().sum().item()
    whole = (err2 / ref2) ** 0.5
    adam, adam1 = pay["opt_state"]["1"]["0"], one["opt_state"]["1"]["0"]
    assert int(adam["count"]) == int(adam1["count"]), (adam["count"], adam1["count"])
    moments = {}
    for m in ("mu", "nu"):
        a, b = sd(adam[m]), sd(adam1[m])
        moments[m] = max((((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)).item(), k)
                         for k in b)
    return worst, whole, moments


def _k1_rank_check(r, order, lim):
    """K1 against its plain version on a rank's own lags (phase 2's limits
    for order-150 FDLP lags): (P, max|err|, t_need, worst, kernel ms, plain
    ms)."""
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        lpc_cepstra,
        lpc_cepstra_reference,
    )

    r = r.reshape(-1, r.shape[-1])
    got = lpc_cepstra(r, order, lim)
    ref = lpc_cepstra_reference(r, order, lim)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    t_need = (err / (1 + ref.abs())).max().item()
    worst = (err.amax(0) / ref.abs().mean(0).clamp_min(1e-30)).max().item()
    assert t_need <= NEAR_PERIODIC_TOL and worst <= NEAR_PERIODIC_REL, (t_need, worst)
    k_ms = graph_ms(lambda: lpc_cepstra(r, order, lim))
    p_ms = cuda_ms(lambda: lpc_cepstra_reference(r, order, lim), reps=1, repeats=3)
    return r.shape[0], err.max().item(), t_need, worst, k_ms, p_ms


def parallel_rank(rank, world, jobs):
    """A rank of phase 18's worlds: runs each (name, function, kwargs) job of
    `jobs` in order (every rank the same list) and returns {name: result}.
    A failure ends the rank with its traceback, and the world with it."""
    torch.set_num_threads(2)
    rec = _Recorder()
    return {name: globals()[fn](rec, rank, world, **kw) for name, fn, kw in jobs}


def _p18_dp_featgen(rec, rank, world, scp, out, x, lens):
    """compute_fdlp_spectrogram --data_parallel: K1 on this rank's rows of
    every bucket batch; then K1 against its plain version on this rank's
    rows of the first batch."""
    from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram
    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_lags
    from speech_recognition_tools_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    dev = torch.device("cuda")
    s, share, launches, _ = rec.run(compute_fdlp_spectrogram.main,
                                    [scp, out, *WSJ_FDLP_FLAGS, *PAR_FEAT_BUCKET,
                                     "--data_parallel"])
    cfg = FdlpConfig(nfilters=80, order=150, fduration=1.5, coeff_num=100, coeff_range="1,100")
    first = np.argsort(lens, kind="stable")[:32]
    mine = first[batch_sharding(make_mesh()).rows(len(first))]
    r, _ = fdlp_lags(x[mine], lens[mine], cfg, device=dev)
    return dict(s=s, share=share, launches=launches,
                k1=_k1_rank_check(r, cfg.order, cfg.coeff_num))


def _p18_seq_featgen(rec, rank, world, x, lens):
    """The frame-sharded and the input-sharded FDLP over a 'time' axis of
    the world, on full-length utterances; K1 against its plain version on
    this rank's block of frames."""
    from speech_recognition_tools_tpu_torch.dsp import fdlp
    from speech_recognition_tools_tpu_torch.ops.framing import (
        frame_count,
        frame_params,
        frame_signal,
    )
    from speech_recognition_tools_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda")
    cfg = fdlp.FdlpConfig(nfilters=80, order=150, fduration=1.5, coeff_num=100,
                          coeff_range="1,100")
    mesh = Mesh({"time": world})
    out = {}
    C = x.shape[1] // world
    block = x[:, rank * C:(rank + 1) * C]
    # warm: the first call of each also opens the groups' connections
    fdlp.fdlp_spectrogram_sharded(x, lens, cfg, mesh, device=dev)
    fdlp.fdlp_spectrogram_input_sharded(block, lens, cfg, mesh, device=dev)
    s, share, launches, (f, n) = rec.run(
        lambda: fdlp.fdlp_spectrogram_sharded(x, lens, cfg, mesh, device=dev))
    out["seq"] = dict(s=s, share=share, launches=launches, feats=f.cpu().numpy(),
                      n=n.cpu().numpy())
    s, share, launches, (f, n) = rec.run(
        lambda: fdlp.fdlp_spectrogram_input_sharded(block, lens, cfg, mesh, device=dev))
    out["input"] = dict(s=s, share=share, launches=launches, feats=f.cpu().numpy(),
                        n=n.cpu().numpy())
    fp = frame_params(cfg.srate, cfg.lfr, cfg.fduration)
    Fl = -(-frame_count(x.shape[1], fp) // world)
    xt = torch.as_tensor(x, device=dev)
    frames, _ = frame_signal(xt, torch.as_tensor(lens, device=dev), fp,
                             torch.ones(fp.flength_samples, device=dev), Fl,
                             first_frame=rank * Fl)
    r = fdlp.window_lags(frames.reshape(-1, fp.flength_samples), cfg, device=dev)
    out["k1"] = _k1_rank_check(r, cfg.order, cfg.coeff_num)
    return out


def _p18_train_e2e(rec, rank, world, argv):
    """train_e2e.main with a parallel mode: first-step loss and gradient
    norm, the second step's ms, the exchange share."""
    from speech_recognition_tools_tpu_torch.cli import train_e2e

    s, share, _, losses = rec.run(train_e2e.main, argv)
    ends = rec.step_ends
    return dict(s=s, share=share, loss=rec.losses[0], gnorm=rec.gnorms[0],
                steps=len(rec.gnorms), step_ms=1e3 * (ends[-1] - ends[-2]) if len(ends) > 1
                else None, epoch_losses=losses)


def _p18_train_am(rec, rank, world, argv):
    """train_am.main with a parallel mode: first-step loss and gradient
    norm, the exchange share, K3's launches on this rank."""
    from speech_recognition_tools_tpu_torch.cli import train_am

    K3.reset()
    s, share, _, st = rec.run(train_am.main, argv)
    return dict(s=s, share=share, loss=rec.losses[0], gnorm=rec.gnorms[0],
                steps=len(rec.gnorms), train_loss=st.history[0]["train_loss"],
                k3=gru_scan.launches)


def _p18_ring(rec, rank, world, model_dir, feats, lengths, egs, out):
    """encode_ring over the world against the offline encode, then
    recog_e2e --ring_attention over the world."""
    from speech_recognition_tools_tpu_torch.cli import recog_e2e
    from speech_recognition_tools_tpu_torch.models.transformer_asr import encode_ring
    from speech_recognition_tools_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda")
    model, _, _ = recog_e2e._load(model_dir, "final_avg", device=dev)
    f, n = torch.as_tensor(feats, device=dev), torch.as_tensor(lengths, device=dev)
    mesh = Mesh({"time": world})
    with torch.no_grad():
        ref = model.encode(f, n)
        encode_ring(model, f, n, mesh)  # warm
        s, share, _, got = rec.run(lambda: encode_ring(model, f, n, mesh))
        plain_s, _, _, _ = rec.run(lambda: model.encode(f, n))
    errs = [max((got[i][b, : int(ref[1][b])] - ref[i][b, : int(ref[1][b])]).abs().max().item()
                for b in range(len(lengths))) for i in (0, 2)]
    assert torch.equal(got[1], ref[1])
    rs, rshare, _, hyps = rec.run(recog_e2e.main, [model_dir, egs, out, *PAR_RING_DECODE,
                                                   "--ring_attention", str(world)])
    return dict(s=s, share=share, plain_s=plain_s, mem_err=errs[0], ctc_err=errs[1],
                recog_s=rs, recog_share=rshare, hyps=hyps)


def _p18_nccl(rec, rank, world, argv):
    """The NCCL path: one all-reduce and a barrier on the card, then one
    data-parallel train_e2e epoch."""
    import torch.distributed as dist

    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    dist.barrier()
    assert dist.get_backend() == "nccl" and t[0].item() == world * (world + 1) / 2
    return _p18_train_e2e(rec, rank, world, argv)


def parallel_phase(x, lens, fdlp_cfg, rng, dev, tmp, beside=None):
    """Phase 18: the parallel layer over worlds of local ranks on this card
    (parallel/launcher.py::launch). Returns K1's launches by path.

    The worlds run from a thread while this one runs `beside` (phase 17),
    then the one-process references: their minutes hide behind it, and the
    ranks, it and the references share the card and the host, so each one's
    times include the others' load."""
    from scipy.io.wavfile import write as wav_write

    from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram
    from speech_recognition_tools_tpu_torch.cli import recog_e2e, train_am, train_e2e
    from speech_recognition_tools_tpu_torch.dsp.fdlp import fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax
    from speech_recognition_tools_tpu_torch.parallel.launcher import launch
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint
    from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn, cmvn_stats_masked

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
    rec = _Recorder()

    # (a) inputs: phase 3's 32 utterances as wavs; (b) 4 full-length 60 s
    # utterances; (d) 4 utterances of 20-30 s, featgen + CMVN -> egs
    os.makedirs(j("p18_wavs"), exist_ok=True)
    with open(j("p18_wav.scp"), "w") as f:
        for b in range(len(lens)):
            path = j("p18_wavs", f"utt{b:02d}.wav")
            wav_write(path, 16000, np.clip(x[b, : lens[b]], -32768, 32767).astype(np.int16))
            f.write(f"utt{b:02d} {path}\n")
    xq = np.zeros_like(x)
    for b in range(len(lens)):  # the CLI reads the int16 samples
        xq[b, : lens[b]] = np.clip(x[b, : lens[b]], -32768, 32767).astype(np.int16)
    xs, _ = speechlike_batch(rng, PAR_SEQ_UTTS, PAR_SEQ_SECONDS, PAR_SEQ_SECONDS)
    ls = np.full(PAR_SEQ_UTTS, xs.shape[1] - xs.shape[1] % 4, np.int32)
    xs = xs[:, : ls[0]]
    xr, lr = speechlike_batch(rng, PAR_RING_UTTS, *PAR_RING_SECONDS)
    fr, nr = fdlp_spectrogram_batch(xr, lr, fdlp_cfg, device=dev)
    fr = apply_cmvn(fr, *cmvn_stats_masked(fr, nr))
    build_egs(((f"r{b}", fr[b, : int(nr[b])].cpu().numpy()) for b in range(PAR_RING_UTTS)),
              j("p18_ring_egs"))
    feats_r = fr.cpu().numpy()
    nr = nr.cpu().numpy()

    def e2e_argv(store, flags):
        return [j("e2e_egs"), j("e2e_text"), j(store), "--init_from", j("e2e_am"),
                "--epochs", "1", "--dropout", "0.0", "--batch_size", "32",
                "--average_last", "1", "--device", "cuda", *flags]

    am_common = [j("hyb_egs"), "--epochs", "1", "--device", "cuda",
                 *[a for k, v in HYBRID_TRAIN.items() if k != "epochs"
                   for a in (f"--{k}", str(v))]]
    curl = ["--arch", "curl", "--comp_num", "2", "--bn_dim", "64", "--num_layers_dec", "1"]

    jobs2 = [("dp_featgen", "_p18_dp_featgen",
              dict(scp=j("p18_wav.scp"), out=j("p18_dp"), x=xq, lens=lens)),
             ("seq_featgen", "_p18_seq_featgen", dict(x=xs, lens=ls))]
    jobs2 += [(f"e2e_{m}", "_p18_train_e2e", dict(argv=e2e_argv(f"p18_{m}", flags)))
              for m, flags in PAR_E2E_MODES.items()]
    jobs2 += [("ring", "_p18_ring", dict(model_dir=j("e2e_am"), feats=feats_r, lengths=nr,
                                         egs=j("p18_ring_egs"), out=j("p18_hyp_ring.txt"))),
              ("am_dp", "_p18_train_am",
               dict(argv=[am_common[0], j("p18_am_dp"), *am_common[1:], "--data_parallel"])),
              ("am_ep", "_p18_train_am",
               dict(argv=[am_common[0], j("p18_am_ep"), *am_common[1:], *curl,
                          "--expert_parallel", "2"]))]
    jobs4 = [("e2e_dpxpp", "_p18_train_e2e",
              dict(argv=e2e_argv("p18_dpxpp", ["--data_parallel", *PAR_E2E_MODES["pp"]])))]
    jobs1 = [("e2e_nccl", "_p18_nccl", dict(argv=e2e_argv("p18_nccl", ["--data_parallel"])))]

    def run_worlds():
        worlds, lines = {}, []
        for n, jobs, backend in ((2, jobs2, "gloo"), (4, jobs4, "gloo"), (1, jobs1, "nccl")):
            t = time.perf_counter()
            worlds[(n, backend)] = launch("chip_smoke:parallel_rank", n, (jobs,),
                                          backend=backend, env=env, timeout_s=PAR_TIMEOUT_S,
                                          cwd=here)
            lines.append(f"[parallel] {n}-rank {backend} world ({len(jobs)} jobs, each rank a "
                         f"process on {torch.cuda.get_device_name(0)}): "
                         f"{time.perf_counter() - t:.1f} s with startup")
        return worlds, lines

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_worlds)
        if beside is not None:
            beside()
        # the one-process references on the card
        t_ref = time.perf_counter()
        _, _, ref_launches, _ = rec.run(_captured, compute_fdlp_spectrogram.main,
                                        [j("p18_wav.scp"), j("p18_one"), *WSJ_FDLP_FLAGS,
                                         *PAR_FEAT_BUCKET, "--batch_size", str(len(lens) // 2)])
        one = dict(read_ark(j("p18_one.ark")))
        fs, ns = fdlp_spectrogram_batch(xs, ls, fdlp_cfg, device=dev)
        fs, ns = fs.cpu().numpy(), ns.cpu().numpy()
        refs = {}
        for tag, argv in (("e2e", e2e_argv("p18_one_e2e", [])),
                          ("rnn", [am_common[0], j("p18_one_rnn"), *am_common[1:]]),
                          ("curl", [am_common[0], j("p18_one_curl"), *am_common[1:], *curl])):
            fn = train_e2e.main if tag == "e2e" else train_am.main
            s, _, _, _ = rec.run(_captured, fn, argv)
            refs[tag] = dict(s=s, loss=rec.losses[0], gnorm=rec.gnorms[0],
                             step_ms=(1e3 * (rec.step_ends[-1] - rec.step_ends[-2])
                                      if len(rec.step_ends) > 1 else None))
        _, _, _, (plain_hyps, _) = rec.run(
            _captured, recog_e2e.main,
            [j("e2e_am"), j("p18_ring_egs"), j("p18_hyp_plain.txt"), *PAR_RING_DECODE])
        t_ref = time.perf_counter() - t_ref
        worlds, lines = running.result()
    for line in lines:
        log(line + " (beside phase 17 and the references)")
    w2, w4, w1 = worlds[(2, "gloo")], worlds[(4, "gloo")], worlds[(1, "nccl")]
    note = "(ranks sharing one card: correctness and overhead, not scaling)"

    # (a) data-parallel featgen: the ark of rank 0 against the one-process
    # CLI's over the same batches of each rank's rows
    dp = dict(read_ark(j("p18_dp.ark")))
    assert list(dp) == list(one)
    ferr = max(float(np.abs(dp[k] - one[k]).max()) for k in one)
    for k in one:
        assert dp[k].shape == one[k].shape
        np.testing.assert_allclose(dp[k], one[k], **PAR_FEAT_TOL)
    dp_launches = [r["dp_featgen"]["launches"] for r in w2]
    assert all(n > 0 for n in dp_launches), dp_launches
    for r_, res in enumerate(w2):
        P, err, t_need, worst, k_ms, p_ms = res["dp_featgen"]["k1"]
        log(f"[parallel] dp_featgen rank {r_}: K1 launches {res['dp_featgen']['launches']}, "
            f"first batch's rows P={P}: max|kernel - plain| {err:.3e}, allclose needs "
            f"{t_need:.3e}, worst {worst:.3e} (limits {NEAR_PERIODIC_TOL}, "
            f"{NEAR_PERIODIC_REL}); kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
            f"bound_ms={1e3 * k1_bound_s(P, 150, 100):.5f}")
    a = w2[0]["dp_featgen"]
    log(f"[parallel] (a) compute_fdlp_spectrogram --data_parallel, 2 ranks, 32 utterances at "
        f"wsj_fdlp_e2e: {a['s'] * 1e3:.0f} ms ({100 * a['share']:.1f}% in exchanges) against "
        f"one process {ref_launches} K1 launches on each rank's rows as a batch; ark "
        f"max|2 ranks - 1 process| {ferr:.3e} "
        f"(rtol 1e-3, atol 2e-3); audio {float(lens.sum()) / 16000:.1f} s = "
        f"{float(lens.sum()) / 16000 / a['s']:.1f}x real time per world, "
        f"{float(lens.sum()) / 16000 / a['s'] / 2:.1f}x per rank {note}")

    # (b) the sequence-sharded FDLP against the one-process batch on the card
    seq_launches, in_launches = 0, 0
    for kind in ("seq", "input"):
        got = w2[0]["seq_featgen"][kind]
        assert np.array_equal(got["n"], ns)
        for b in range(PAR_SEQ_UTTS):
            T = int(ns[b])
            np.testing.assert_allclose(got["feats"][b, :T], fs[b, :T], **PAR_FEAT_TOL)
        launches = [r["seq_featgen"][kind]["launches"] for r in w2]
        assert all(n > 0 for n in launches), (kind, launches)
        if kind == "seq":
            seq_launches = sum(launches)
        else:
            in_launches = sum(launches)
        err = max(float(np.abs(got["feats"][b, : int(ns[b])] - fs[b, : int(ns[b])]).max())
                  for b in range(PAR_SEQ_UTTS))
        log(f"[parallel] (b) {'frame' if kind == 'seq' else 'input'}-sharded FDLP, 'time' "
            f"axis of 2, {PAR_SEQ_UTTS} x {PAR_SEQ_SECONDS:g} s: {got['s'] * 1e3:.0f} ms "
            f"({100 * got['share']:.1f}% in exchanges), K1 launches per rank {launches}, "
            f"max|sharded - one batch| {err:.3e} (rtol 1e-3, atol 2e-3) {note}")
    for r_, res in enumerate(w2):
        P, err, t_need, worst, k_ms, p_ms = res["seq_featgen"]["k1"]
        log(f"[parallel] seq_featgen rank {r_} block of frames P={P}: max|kernel - plain| "
            f"{err:.3e}, allclose needs {t_need:.3e}, worst {worst:.3e}; kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.3f} bound_ms={1e3 * k1_bound_s(P, 150, 100):.5f}")

    # (c) training: the first step against the one-process step
    e2e_ref = refs["e2e"]
    runs = {m: w2[0][f"e2e_{m}"] for m in PAR_E2E_MODES}
    runs["dpxpp (4 ranks)"] = w4[0]["e2e_dpxpp"]
    runs["dp (1-rank NCCL)"] = w1[0]["e2e_nccl"]
    for m, res in runs.items():
        assert res["steps"] == 2, (m, res["steps"])
        assert _rel(res["loss"], e2e_ref["loss"]) <= PAR_LOSS_REL, (m, res, e2e_ref)
        assert _rel(res["gnorm"], e2e_ref["gnorm"]) <= PAR_GNORM_REL, (m, res, e2e_ref)
        log(f"[parallel] (c) train_e2e {m}: first-step loss {res['loss']:.6f} (rel "
            f"{_rel(res['loss'], e2e_ref['loss']):.3e}, limit {PAR_LOSS_REL}), grad norm "
            f"{res['gnorm']:.6f} (rel {_rel(res['gnorm'], e2e_ref['gnorm']):.3e}, limit "
            f"{PAR_GNORM_REL}); step 2 {res['step_ms']:.0f} ms against one process "
            f"{e2e_ref['step_ms']:.0f} ms; {100 * res['share']:.1f}% of the run in exchanges "
            f"{note}")
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
    )

    init, _ = load_checkpoint(train_e2e.resolve_init_checkpoint(j("e2e_am"))[0])
    one_p, _ = load_checkpoint(j("p18_one_e2e", "epoch_1"))
    for store in ("p18_dp", "p18_tp", "p18_pp", "p18_dpxpp", "p18_nccl"):
        pay, meta = load_checkpoint(j(store, "epoch_1"))
        (share, leaf), whole, moments = _update_check(init, one_p, pay)
        log(f"[parallel] (c) {store}'s epoch_1 checkpoint (whole model and Adam state, "
            f"written by rank 0) against one process's, key biases left out: the 2 steps' "
            f"parameter change, |error| / |change| over the model {whole:.3e} (limit "
            f"{PAR_UPDATE_REL}), elements off by more than {PAR_UPDATE_REL} of their change + "
            f"an ulp: worst tensor {100 * share:.2f}% ({leaf}; limit "
            f"{100 * PAR_UPDATE_SHARE:.0f}%); Adam mu |a - b| / |b| worst tensor "
            f"{moments['mu'][0]:.3e} ({moments['mu'][1]}), nu {moments['nu'][0]:.3e} "
            f"({moments['nu'][1]}) (limit {PAR_MOMENT_REL})")
        assert whole <= PAR_UPDATE_REL and share <= PAR_UPDATE_SHARE, (store, whole, leaf, share)
        assert max(moments["mu"][0], moments["nu"][0]) <= PAR_MOMENT_REL, (store, moments)
        sd, one_sd = transformer_asr_from_jax(pay["params"]), transformer_asr_from_jax(
            one_p["params"])
        diff = max((sd[k] - one_sd[k]).abs().max().item() for k in sd)
        assert diff <= 1e-5, (store, diff)  # key biases included
        m_ = TransformerASR(TransformerASRConfig(**E2E_AM), fdlp_cfg.nfilters, device=dev)
        m_.load_state_dict(sd)
    log("[parallel] (c) every parallel run's checkpoint loads into the one-process "
        "TransformerASR; max|param - one process's| <= 1e-5 (key biases included)")

    # (d) ring attention
    g = w2[0]["ring"]
    assert g["mem_err"] <= PAR_RING_ATOL and g["ctc_err"] <= PAR_RING_ATOL, g
    assert g["hyps"] == plain_hyps, (g["hyps"], plain_hyps)
    with open(j("p18_hyp_plain.txt")) as a_, open(j("p18_hyp_ring.txt")) as b_:
        assert a_.read() == b_.read()
    log(f"[parallel] (d) encode_ring over 2 ranks, {PAR_RING_UTTS} utterances of "
        f"{PAR_RING_SECONDS[0]:g}-{PAR_RING_SECONDS[1]:g} s ({int(nr.max())} frames): "
        f"{g['s'] * 1e3:.1f} ms ({100 * g['share']:.1f}% in exchanges) against the offline "
        f"encode {g['plain_s'] * 1e3:.1f} ms; max|memory - offline| {g['mem_err']:.3e}, "
        f"max|CTC logits - offline| {g['ctc_err']:.3e} (atol {PAR_RING_ATOL}); recog_e2e "
        f"--ring_attention 2 {g['recog_s']:.1f} s, hypotheses token-identical to the plain "
        f"CLI's {note}")

    # (e) train_am data- and expert-parallel against one process
    for tag, ref in (("am_dp", refs["rnn"]), ("am_ep", refs["curl"])):
        res = w2[0][tag]
        for rank, r in enumerate(w2):
            K3.by_path[f"{tag}_rank{rank}"] = r[tag]["k3"]
        assert _rel(res["loss"], ref["loss"]) <= PAR_LOSS_REL, (tag, res, ref)
        assert _rel(res["gnorm"], ref["gnorm"]) <= PAR_GNORM_REL, (tag, res, ref)
        log(f"[parallel] (e) train_am {'--data_parallel (3 x 512 GRU)' if tag == 'am_dp' else '--arch curl --expert_parallel 2'}: "
            f"first-step loss {res['loss']:.6f} (rel {_rel(res['loss'], ref['loss']):.3e}, "
            f"limit {PAR_LOSS_REL}), grad norm rel {_rel(res['gnorm'], ref['gnorm']):.3e}; "
            f"run {res['s']:.1f} s against one process {ref['s']:.1f} s, "
            f"{100 * res['share']:.1f}% in exchanges, K3 launches by rank "
            f"{[r[tag]['k3'] for r in w2]} {note}")
    log(f"[parallel] one-process references {t_ref:.1f} s; phase 18 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"dp_featgen": sum(dp_launches), "seq_featgen": seq_launches,
            "input_sharded_featgen": in_launches}


def _phase_aligned_rel(got, want):
    """|got e^{-j phi} - want| / max|want|, phi = angle(vdot(want, got)):
    the GEV weights' global phase is arbitrary (ROADMAP Queue 3)."""
    phi = np.angle(np.vdot(want, got))
    return float(np.abs(got * np.exp(-1j * phi) - want).max() / np.abs(want).max())



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(1)

    from speech_recognition_tools_tpu_torch import kernels
    from speech_recognition_tools_tpu_torch.device import configure_cuda
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        fdlp_lags,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.infer.posteriors import (
        compute_log_prior_from_counts,
        genclassifier_outputs,
    )
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        rnn_classifier_from_jax,
    )
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
        launch_plan,
        lpc_cepstra,
        lpc_cepstra_reference,
    )
    from speech_recognition_tools_tpu_torch.utils.cmvn import (
        apply_cmvn,
        cmvn_stats_masked,
    )

    dev = torch.device("cuda")
    configure_cuda()  # TF32 off: the port is held to full-f32 contractions
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator().manual_seed(args.seed)

    # ---- 1. device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from speech_recognition_tools_tpu_torch.io import native

    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        native_build = pool.submit(native.build)
        for name in kernels.KERNELS:
            t_k = time.perf_counter()
            kernels.build(name)
            log(f"[build] {name} built in {time.perf_counter() - t_k:.2f} s")
        log(f"[build] native decoder built ({os.path.basename(native_build.result())}) in "
            f"{time.perf_counter() - t0:.2f} s")
    # each compiled entry function's registers and spills; none allowed in
    # the K1 instantiations that the configs' launch plans pick
    used = {launch_plan(order, lim)[:2] for order, lim in CONFIG_SHAPES}
    for name in kernels.KERNELS:
        for d in kernels.register_report(name):
            plan = name == "lpc_cepstra" and d["template"] in used
            log(f"[build] {name} {d['kernel']}{list(d['template'])}: {d['registers']} "
                f"registers, stack {d['stack']} B, spill stores {d['spill_stores']} B, spill "
                f"loads {d['spill_loads']} B{' (a config plan)' if plan else ''}")
            if plan:
                assert d["spill_stores"] == d["spill_loads"] == d["stack"] == 0, d

    phase_done(1, t_run, t_run)
    t2 = time.perf_counter()
    # ---- 2. K1 against its plain version; the kernels alone ----
    all_lanes, _ = kernels.instantiations()
    TOL = 1e-4
    k1_err = 0.0
    cases = [(23040, 150, 100, False), (10240, 50, 50, False),
             (1001, 30, 40, False), (4096, 30, 40, True),
             (2048, 20, 1, False), (2048, 20, 2, False),
             (23040, 150, 450, False), (999, 150, 100, False),
             (2048, 20, 60, False), (513, 3, 10, False)]
    # an order at each chunk boundary of the configs' plans, and one above
    for order, lim in CONFIG_SHAPES[:2]:
        lanes, chunk, _ = launch_plan(order, lim)
        cases += [(999, lanes * chunk, 60, False), (999, lanes * chunk + 1, 60, False)]
    lags = {}
    for P, order, lim, unity in cases:
        if (P, order) not in lags:
            lags[(P, order)] = ar_lags(P, order, gen, dev)
        r = lags[(P, order)]
        got = lpc_cepstra(r, order, lim, unity_gain=unity)
        ref = lpc_cepstra_reference(r, order, lim, unity_gain=unity)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        assert torch.isfinite(got).all(), (P, order, lim)
        assert torch.allclose(got, ref, rtol=TOL, atol=TOL), (P, order, lim, unity, err)
        k1_err = max(k1_err, err)
        log(f"[k1] P={P} order={order} lim={lim} unity_gain={unity} "
            f"plan={launch_plan(order, lim)} max|err|={err:.3e}")
    log(f"[k1] AR lags: max|err| {k1_err:.3e} <= rtol=atol={TOL}")
    # every lane count and block size at the swept shapes, each held to the
    # plain version (launch_plan's choice among them is pinned by
    # tests/test_torch_k1_plan.py)
    swept = 0
    for P, order, lim in SWEPT_SHAPES:
        r = lags[(P, order)]
        ref = lpc_cepstra_reference(r, order, lim)
        for lanes in all_lanes:
            for threads in (64, 128, 256):
                try:
                    plan = launch_plan(order, lim, lanes=lanes, threads=threads)
                except ValueError:
                    continue
                got = lpc_cepstra(r, order, lim, plan=plan)
                torch.cuda.synchronize()
                assert torch.allclose(got, ref, rtol=TOL, atol=TOL), (P, order, lim, plan)
                swept += 1
    log(f"[k1] {swept} plans over every lane count and block size at {SWEPT_SHAPES}: each "
        f"within rtol=atol={TOL}")
    e2e = FdlpConfig(nfilters=80, order=150, fduration=1.5, coeff_num=100,
                     coeff_range="1,100")
    sig = near_periodic()
    r, _ = fdlp_lags(sig, np.asarray([sig.shape[1]]), e2e, device=dev)
    r = r.reshape(-1, r.shape[-1])
    got = lpc_cepstra(r, e2e.order, e2e.coeff_num)
    ref = lpc_cepstra_reference(r, e2e.order, e2e.coeff_num)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), "K1 non-finite on near-periodic FDLP lags"
    _, np_t, np_rel = cep_agreement(f"near-periodic FDLP lags P={r.shape[0]}", got, ref)
    # ~4x the readings recorded in PERF.md (1.3e-3 and 3.9e-2): these
    # near-periodic order-150 rows are ill-conditioned in f32
    assert np_t <= NEAR_PERIODIC_TOL and np_rel <= NEAR_PERIODIC_REL, (np_t, np_rel)
    # the same lags at the reverb recipe's 450 cepstra (its 80 bands, order
    # 150 and 1.5 s windows; mel in place of its cochlear filterbank)
    got = lpc_cepstra(r, e2e.order, 450)
    ref = lpc_cepstra_reference(r, e2e.order, 450)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), "K1 non-finite on near-periodic lags at lim 450"
    _, np_t, np_rel = cep_agreement(f"near-periodic FDLP lags P={r.shape[0]} lim=450",
                                    got, ref)
    # ~4x the readings recorded in PERF.md (1.2e-3 and 4.9e-2)
    assert np_t <= NEAR_PERIODIC_TOL and np_rel <= NEAR_PERIODIC_REVERB_REL, (np_t, np_rel)
    table = kernel_table(gen, dev)

    phase_done(2, t2, t_run)
    t3 = time.perf_counter()
    # ---- 3. featgen at the wsj_fdlp_e2e front-end ----
    x, lens = speechlike_batch(rng, 32, 6.0, 10.0)
    audio_s = float(lens.sum()) / 16000
    lpc_cepstra.launches = 0
    fa, na = fdlp_spectrogram_batch(x, lens, e2e, device=dev)
    featgen_launches = lpc_cepstra.launches
    scan = FdlpConfig(**{**e2e.__dict__, "lpc_backend": "scan"})
    fs, ns = fdlp_spectrogram_batch(x, lens, scan, device=dev)
    assert featgen_launches > 0, "featgen did not launch K1"
    assert torch.equal(na, ns)
    va, vs = valid_rows(fa, na), valid_rows(fs, ns)
    assert torch.isfinite(va).all() and torch.isfinite(vs).all()
    ferr = (va - vs).abs().max().item()
    assert torch.allclose(va, vs, rtol=1e-3, atol=2e-3), ferr
    log(f"[featgen] wsj_fdlp_e2e 32 x 6-10 s ({audio_s:.1f} s audio): K1 launches "
        f"{featgen_launches}; max|auto(K1) - scan(plain)| on valid frames {ferr:.3e} "
        f"(rtol 1e-3, atol 2e-3)")

    phase_done(3, t3, t_run)
    t4 = time.perf_counter()
    # ---- 4. the main path: hybrid slice at timit_hybrid ----
    hyb = FdlpConfig()  # timit_hybrid.json front-end: 20 / 50 / 0.5 s / 50 cepstra
    LAYERS, HIDDEN, CLASSES = 3, 512, 3376
    xh, lh = speechlike_batch(rng, 32, 2.0, 6.0)
    params = random_gru_params(rng, hyb.nfilters, LAYERS, HIDDEN, CLASSES)
    model = RNNClassifier(hyb.nfilters, LAYERS, HIDDEN, CLASSES, device=dev)
    model.load_state_dict(rnn_classifier_from_jax(params))
    model.eval()
    log_prior = compute_log_prior_from_counts(rng.randint(1, 1000, CLASSES))

    def front(cfg):
        feats, n = fdlp_spectrogram_batch(xh, lh, cfg, device=dev)
        return apply_cmvn(feats, *cmvn_stats_masked(feats, n)), n

    def am(feats, n):
        with torch.no_grad():
            return genclassifier_outputs(model(feats, n), log_prior)

    lpc_cepstra.launches = 0
    feats, nfr = front(hyb)
    ll = am(feats, nfr)
    torch.cuda.synchronize()
    main_launches = lpc_cepstra.launches
    assert main_launches > 0, "the main path did not launch K1"
    assert ll.shape == (32, feats.shape[1], CLASSES) and feats.shape[2] == hyb.nfilters
    assert torch.isfinite(valid_rows(ll, nfr)).all() and torch.isfinite(
        valid_rows(feats, nfr)).all()
    # the same chain through the plain LPC backend
    feats_s, nfr_s = front(FdlpConfig(lpc_backend="scan"))
    ll_s = am(feats_s, nfr_s)
    assert torch.equal(nfr, nfr_s)
    llerr = (valid_rows(ll, nfr) - valid_rows(ll_s, nfr)).abs().max().item()
    assert llerr < 1e-2, llerr
    # the AM on the card against the same weights on the CPU (two utterances)
    cpu_model = RNNClassifier(hyb.nfilters, LAYERS, HIDDEN, CLASSES, device="cpu")
    cpu_model.load_state_dict(rnn_classifier_from_jax(params))
    two = nfr[:2].cpu()
    with torch.no_grad():
        lo_cpu = cpu_model(feats[:2, : int(two.max())].cpu(), two)
        lo_gpu = model(feats[:2, : int(two.max())], nfr[:2]).cpu()
    amerr = (valid_rows(lo_gpu, two) - valid_rows(lo_cpu, two)).abs().max().item()
    assert amerr < 1e-4, amerr
    device_breakdown("hybrid front-end batch", lambda: front(hyb))
    device_breakdown("hybrid AM batch", lambda: am(feats, nfr))
    t_front, (feats, nfr) = wall_s(lambda: front(hyb))
    t_am, _ = wall_s(lambda: am(feats, nfr))
    hyb_audio = float(lh.sum()) / 16000
    log(f"[hybrid] timit_hybrid 32 x 2-6 s ({hyb_audio:.1f} s audio), frames "
        f"{int(nfr.sum())}, LL {tuple(ll.shape)}: K1 launches {main_launches}; "
        f"max|LL(K1) - LL(plain)| {llerr:.3e} (atol 1e-2); "
        f"max|AM cuda - cpu| {amerr:.3e} (atol 1e-4)")
    log(f"[hybrid] per batch: front-end {t_front * 1e3:.2f} ms, AM {t_am * 1e3:.2f} ms, "
        f"total {(t_front + t_am) * 1e3:.2f} ms = {hyb_audio / (t_front + t_am):.1f}x "
        f"real time")

    # K1 against its plain version on the main path's own lags
    r, _ = fdlp_lags(xh, lh, hyb, device=dev)
    r = r.reshape(-1, r.shape[-1])
    got = lpc_cepstra(r, hyb.order, hyb.coeff_num)
    ref = lpc_cepstra_reference(r, hyb.order, hyb.coeff_num)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _, main_t, main_rel = cep_agreement(f"main-path lags P={r.shape[0]}", got, ref)
    # 4-6x the readings recorded in PERF.md (1.7e-4 and 2.7e-3); the
    # per-coefficient limit holds the small late cepstra too
    assert main_t <= MAIN_PATH_TOL and main_rel <= MAIN_PATH_REL, (main_t, main_rel)

    phase_done(4, t4, t_run)
    t5 = time.perf_counter()
    # ---- 5. the e2e slice at wsj_fdlp_e2e ----
    e2e_launches, e2e_model = e2e_phase(x, lens, e2e, rng, dev)
    phase_done(5, t5, t_run)

    # ---- 6-7. the training paths; 8. online serving ----
    with tempfile.TemporaryDirectory() as tmp:
        t6 = time.perf_counter()
        hybrid_train_launches = hybrid_train_phase(xh, lh, rng, dev, tmp)
        phase_done(6, t6, t_run)
        t7 = time.perf_counter()
        e2e_train_launches = e2e_train_phase(x, lens, e2e, rng, dev, tmp)
        phase_done(7, t7, t_run)
        t8 = time.perf_counter()
        serve_launches, transcribe_launches, _ = serve_phase(x, lens, e2e, fa, na, rng, dev,
                                                             tmp)
        phase_done(8, t8, t_run)
        # ---- 9. the LM stage, the hybrid decode end, ctc_weight 1.0 ----
        t9 = time.perf_counter()
        K3.reset()
        lm_train_phase(e2e_model, rng, dev, tmp)
        K3.read("rnnlm_lm_loss")
        K3.reset()
        decode_launches = hybrid_decode_phase(rng, dev, tmp)
        K3.read("hybrid_posteriors")
        ctc_only_check(e2e_model)
        phase_done(9, t9, t_run)
        # ---- 10. the MFCC hybrid front-end and the conformer ----
        t10 = time.perf_counter()
        K3.reset()
        mfcc_phase(x, lens, rng, dev, tmp)
        K3.read("mfcc_train")
        conf_launches, conf_stream_launches = conformer_phase(x, lens, e2e, fa, na, rng, dev,
                                                              tmp)
        phase_done(10, t10, t_run)
        # ---- 11. precision high, the modulation spectrum, the KV-cached decoder ----
        t11 = time.perf_counter()
        high_precision_phase(x, lens, e2e, fa, na, dev)
        modspec_launches = modspec_phase(x, lens, dev, tmp)
        incremental_phase(e2e_model, dev)
        phase_done(11, t11, t_run)
        # ---- 12. bf16 compute, the LSTM RNNLM, the checkpoint importer ----
        t12 = time.perf_counter()
        bf16_launches, feats_n, nfr_n = bf16_phase(e2e_model, x, lens, e2e, fa, na, rng, dev,
                                                   tmp)
        lstm_lm_phase(e2e_model, e2e.nfilters, dev, tmp)
        import_phase(feats_n, nfr_n, hyb.nfilters, dev, tmp, args.seed)
        phase_done(12, t12, t_run)
        # ---- 13. the hybrid recipes' PM stage, the recurrent half of the zoo ----
        t13 = time.perf_counter()
        K3.reset()
        pm_launches = pm_stage_phase(rng, dev, tmp)
        K3.read("pm_stage")
        K3.reset()
        zoo_phase(dev, tmp)
        K3.read("zoo")
        phase_done(13, t13, t_run)
        # ---- 14. the conv zoo, adaptation, lifelong decoding, the CL decode ----
        t14 = time.perf_counter()
        conv_zoo_phase(dev, tmp, args.seed)
        K3.reset()
        adapt_launches = adapt_phase(rng, dev, tmp)
        K3.read("adapt")
        K3.reset()
        lifelong_phase(dev, tmp)
        K3.read("lifelong")
        cl_phase(e2e_model, dev, tmp)
        phase_done(14, t14, t_run)
        # ---- 15. int8 serving, the look-ahead word LM, forced alignment ----
        t15 = time.perf_counter()
        int8_launches = int8_phase(x, lens, e2e, fa, na, rng, dev, tmp)
        wordlm_launches = wordlm_phase(x, lens, e2e, rng, dev, tmp)
        K3.reset()
        align_launches = align_phase(xh, lh, rng, dev, tmp)
        K3.read("align")
        phase_done(15, t15, t_run)
        # ---- 16. stage-0 enhancement, SE scores, augmented featgen ----
        t16 = time.perf_counter()
        enh_launches = enhance_phase(rng, dev, tmp, args.seed)
        phase_done(16, t16, t_run)
        # ---- 17. the recipe drivers, the babysitter, device prefetch, run
        # ---- beside 18. the parallel layer's worlds of ranks on this card
        t17, recipe_launches = time.perf_counter(), {}

        def recipes():
            recipe_launches.update(recipe_phase(dev, tmp, args.seed))
            phase_done(17, t17, t_run)

        parallel_launches = parallel_phase(x, lens, e2e, rng, dev, tmp, beside=recipes)
        phase_done(18, t17, t_run)  # phase 17 included

    # ---- 19. every kernel of the port ----
    log(f"[k3] launches by path: {K3.by_path}")
    log(json.dumps({"kernels": [{
        "name": "lpc_cepstra",
        "route": "cuda",
        "source": "speech_recognition_tools_tpu_torch/csrc/lpc_cepstra.cu",
        "replaces": "speech_recognition_tools_tpu/ops/pallas_lpc.py:31",
        "launches": main_launches,
        "launches_by_path": {"featgen": featgen_launches, "hybrid": main_launches,
                             "e2e": e2e_launches, "hybrid_train": hybrid_train_launches,
                             "e2e_train": e2e_train_launches, "serve": serve_launches,
                             "transcribe": transcribe_launches,
                             "hybrid_decode": decode_launches,
                             "conformer_e2e": conf_launches,
                             "conformer_stream": conf_stream_launches,
                             "modspec": modspec_launches, "bf16_e2e": bf16_launches,
                             "pm_stage": pm_launches, "adapt": adapt_launches,
                             "int8_serve": int8_launches[0],
                             "int8_transcribe": int8_launches[1],
                             "int8_conformer_stream": int8_launches[2],
                             "wordlm_decode": wordlm_launches, "align": align_launches,
                             "enhanced_augmented_featgen": enh_launches,
                             **recipe_launches, **parallel_launches},
        **table["lpc_cepstra"],
    }, {
        "name": "ctc_prefix",
        "route": "cuda",
        "source": "speech_recognition_tools_tpu_torch/csrc/ctc_prefix.cu",
        # no Pallas kernel: XLA fused the JAX package's lax.scan
        "replaces": "speech_recognition_tools_tpu/decode/ctc_prefix.py (lax.scan)",
        "launches": K2.by_path["e2e"],
        "launches_by_path": K2.by_path,
        "search_graph_captures_by_path": GRAPHS.by_path,
        **table["ctc_prefix"],
    }, {
        "name": "gru_scan",
        "route": "cuda",
        "source": "speech_recognition_tools_tpu_torch/csrc/gru_scan.cu",
        # no Pallas kernel: XLA compiled the JAX package's lax.scan
        "replaces": "speech_recognition_tools_tpu/models/recurrent.py (lax.scan)",
        "launches": K3.by_path["hybrid_train"],
        "launches_by_path": K3.by_path,
        **table["gru_scan"],
        "layer_ms": table["gru_scan"]["call_ms"],  # its call is a layer through autograd
    }]}))

    log(f"[run] {time.perf_counter() - t_run:.1f} s from start to the contract line")
    # the card again, so that the end of the output (all a caller may keep)
    # names the card and its power limit beside the numbers above
    log(smi)

    # ---- 20. contract line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
