#!/usr/bin/env python3
"""Drive the PyTorch port (`tpuasr_torch`) through its serving path, its
training step, its trainer, its CTC, AED, Paraformer and Whisper
workloads, the transducer's model options, its encoder families, its
serving export and its parallel layer on one NVIDIA card, and hold its
hand-written kernels against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. Device: require CUDA; print torch's CUDA version, nvcc's version and the
   card's name and power limit (nvidia-smi).
2. Build: compile every kernel source of tpuasr_torch/csrc at once (one nvcc
   per source, started together) and print the time and ptxas' register
   and spill lines, each labelled with its kernel.
3. Kernels against their plain versions on the card, at the flagship's
   shapes: fbank on the 16 waves of fixtures/example1.npz (48 kHz) and on
   a seeded 8 s batch, in both precisions, and on the training batch of
   phase 6b (bench.py's 12 waves, 9,216 frames) in precision "default"
   (the tensor-core route: its plan and own work at each shape, its time
   at each block shape the kernel builds on the fixture and the training
   batch, and at the training batch two calls bit-identical and its device
   time by kernel); "highest" takes the FFT route at n_fft 1024 (its plan
   and own work, each route's error against a float64 DFT; at the fixture
   two calls bit-identical, silent frames at -100 dB, its device time by
   kernel, its time at each count of frames a block, the dense kernel
   timed on the same frames and torch.fft.rfft of the windowed frames
   timed as one stage);
   rel-pos attention forward (#2) at [4, 187, 256] (8 s after subsampling)
   and [16, 63, 256] (the fixture requests), fp32 and bf16, with a fully
   masked row; the attention forward and backward (#2/#3) at the training
   shape ([12, 191, 256] bf16, a dynamic-chunk mask), at an fp32 ragged
   shape with a fully masked row, with a [B, 1, S] mask and at 6a's fp32
   step ([2, 63, 256]) (the forward writing each row's log-sum-exp beside
   its output, bf16 also its fp32 output, held against the plain ones; #3
   timed alone on what the forward saved, fp32's two calls bit-identical;
   at the training shape both bf16 kernels and the plain bf16 versions
   against the fp32 plain version on the same bf16 values; #3's kernels
   profiled at 6a's fp32 step; fp32's bound at the 3xTF32
   floor, the CUDA-core figure beside it; the SDPA backend); the fused RNN-T
   joint forward and backward (#4/#5), the RNN-T lattice (#8/#9) and the
   CTC alpha and beta sweeps (#6/#7) at the training step's shapes (B 12,
   T' 191, U+1 33, S 65, D 256, V 412) and at a ragged shape with a
   t_len = 0 and a label_len = 0 row (#6/#7 and #8/#9 also at the
   trainer's T' 63 and 127, U+1 17, on the warp route the plan takes and on
   the block route, each with its time per dependent step (CTC: a frame;
   RNN-T: an anti-diagonal), two calls bit-identical, its device time by
   kernel and both routes timed in turns; #8/#9 by both routes, in turns,
   at U+1 = 32K for K 1-8, B 12 and T' 191 and B 4 and T' 60, the warp
   route held against the block route: the reading behind the plan's
   route; #4 and #5 also twice at each,
   bit-identical, and their device time by kernel at the training shape:
   #4's W tiles and rows, #5's row side, vocabulary side and sum; #4's plan
   and the bytes of W its blocks read from L2 at each shape, and #4 held
   and timed at the trainer's shapes too, T' 63 and 127 at U+1 17; #4/#5's
   bound at the 3xTF32 floor, the fp32 CUDA-core figure beside it); the
   fused FFN forward and backward
   (#10/#11) at the training shape (12 x 191 rows, D 256, H 1024, bf16,
   keep-masks at rate 0.1, scale 0.5: two calls bit-identical, each call's
   device time by kernel, and timed at other counts of H slices), at the
   serving shape (4 x 187 rows, no masks) and at a streaming chunk (4 x 32
   rows), fp32 and (#10) bf16. Max abs
   error, its tolerance and the reason, kernel ms, plain ms, bound, and the
   ms of one PyTorch call computing the same function where there is one
   (attention: `scaled_dot_product_attention` on [q+u | q+v], [k | p], v,
   and its backward; CTC: `torch.nn.functional.ctc_loss` forward, and its
   backward; the fused joint, the RNN-T lattice and the fused FFN: none).
   Kernels are timed by CUDA events; the plain lattices, the plain attention
   backward and FFNs, F.ctc_loss and the SDPA backward by the profiler
   (`timing`). One function, `_held`, holds each kernel's tolerance, bound
   and library call, for this phase and for phase 8.
4. Offline serving: the full-width flagship (12 causal conformer blocks,
   d256, 4 heads, FFN 1024, conv 31, LSTM-256 predictor, tanh joint over
   412 tokens, `fused_attention=True`) with seeded random weights, through
   `make_offline_decoder("rnnt_greedy")`. The blank logit is raised until
   greedy search emits as many tokens per encoder frame as the fixture's
   transcripts hold (texts/text_lens), so the emission loop runs as often as
   it would for real speech. fp32 on the card against the same model and
   requests on the CPU (plain versions): features, encoder output and
   tokens. The same weights with `fused_ffn=True` (kernel #10 in every FFN)
   must give the card's fp32 tokens. Then bf16: the card's encoder output
   against the same bf16 model on the CPU, latency, and token agreement with
   fp32. After phase 5, outside the serving run's launch counts: the fp32
   request batch's device busy ms with fbank "highest" by the FFT route and
   by the dense kernel, in turns.
4b. The other offline modes, on the same fp32 model and requests: the CTC
   head's blank logit is fitted as the joint's (to the transcripts' tokens
   per frame, by `ctc_greedy`); `rnnt_beam` (beam 4, CTC fusion 0 and
   0.3), `ctc_greedy`, `ctc_prefix_beam` (beam 4, with and without a
   context graph of 2-token hotwords cut from the CPU's best hypotheses)
   and `rnnt_rescoring` (the prefix beam's n-best through the joint's full
   logits and #8) on the card against the CPU: `ctc_greedy` tokens
   identical; for each beam mode d, the largest |card - CPU| score of the
   hypotheses both sides found, and the same best hypothesis on every
   request whose CPU margin (best - second) exceeds 2d, at most 4 of 16
   inside it; `make_offline_decoder` in each mode gives its search's best
   hypothesis; each mode's synced latency after a warm-up call, fp32 and
   bf16, on the fixture and the synthetic batch; `rnnt_beam`'s device busy
   ms (profiler).
5. Streaming serving: `streaming_greedy_decode` (chunk 32, 6 left chunks)
   must give the tokens of offline greedy over the chunk-masked full-context
   encoder, with `fused_ffn` off and on; `measure_rtf` greedy p50/p90 and
   the probe's p50 (a trivial op on the card, synced in the same loop).
5b. Streaming beam: `streaming_beam_decode` (beam 4) must give the tokens
   of `rnnt_beam_decode` over the chunk-masked encoder, on both batches,
   `fused_ffn` off and on, at one emission a frame and at
   `streaming.n_steps` with CTC fusion 0.3; `measure_rtf(mode="beam")`
   p50/p90 and its expansion sub-steps a frame, bf16 and fp32;
   `measure_first_token_delay` p50/p90 on the fixture requests. The serving
   run (4-5b) records #8's inputs on the card (rnnt_rescoring's) and,
   after its launch counts are read, holds #8 against its plain version on
   them: the serving run must launch #8 by its warp route alone and never
   #9, #6 or #7.
6. Training, `fused_attention=True` (kernels #2/#3 in every layer):
   a. card against CPU: the full-width fp32 flagship on a batch of 2 x 256
      feature frames x 16 tokens, no dropout, static chunk 32, once per
      RNN-T loss route (`fused_joint_loss=True`, bench.py's, and False, the
      JAX default) and once more with `fused_joint_loss=True` and
      `fused_ffn=True`: the loss dict, the gradient norm, every gradient leaf
      (max error relative to the leaf's max |g|); the GuardedAdam step alone
      (the CPU's optimizer on the card's gradients: count, moments, weights)
      and end to end (each side's update; no entry whose sign is certain
      moves the other way);
   b. bench.py's configuration (bench.py:51-90): its batch, built by the
      port's copies of `synth_corpus` and `make_batch` (12 utterances of
      24-30 tokens plus SOS and EOS, 768 frames), bf16, fbank precision
      "default", dropout 0.1, dynamic chunk, `fused_joint_loss=True`, ten
      steps of `make_train_step`: every loss finite, synced step ms, audio
      seconds per second, peak memory, and the device's busy time against
      wall from torch.profiler over one step (after one warm-up step under
      the profiler, with 50 ms of idle host on each side of the step: the
      trace drops kernels near its window's edges), with the port's
      kernels in it by name, fbank's pack and tensor-core kernels among
      them. Kernels #1-#9 must launch, fbank once a step and always by its
      tensor-core route (its route counts); then, outside the run's launch
      counts, a fresh model's profiled step's device busy ms with the CTC
      lattice by its block route, then by its warp route, and the same for
      the RNN-T lattice;
   c. the same with `fused_joint_loss=False` (the joint's full logits and
      the materialized loss), four steps: kernels #1-#3 and #6-#9 must
      launch;
   d. 6b with `fused_ffn=True` (bench.py's TPUASR_FUSED_FFN=1): ten steps
      after two; kernels #1-#11 must launch, #10/#11 24 times a step; its
      step ms, audio-s/s, device busy ms, device operations and peak memory
      beside 6b's.
8. The trainer on the card, through `tpuasr_torch.tools.train` (in this
   process): the full-width online_rnnt with its card defaults (bf16, the
   fused joint loss and attention kernels, fbank "default") and
   `fused_ffn=True`, SpecAugment on, the hard synthetic corpus (48
   utterances, batch 12, prefetch depth 2, a 6-utterance dev split), 2
   epochs into a temporary save dir under build/; then `--resume
   .../latest` for a third epoch, which must start at the saved epoch and
   step. Every loss finite; kernels #1-#11 must launch (fbank by its
   tensor-core route alone). The run records
   the arguments of each kernel's first call at each signature (the
   buckets' shapes, the training steps and the dev pass) and counts the
   calls, which must equal the run's launches; then each kernel is held
   against its plain version on those arguments, with phase 3's
   tolerances, bound and library call, and timed at the signature it
   launched most.
9. The corpus on disk and the serving CLIs, each called in this process
   through its `main(argv)`: a BZNSYP-layout corpus written to a temporary
   directory under build/ (a ProsodyLabeling transcript and Wave/*.wav,
   48 kHz 16-bit mono: 64 utterances of 8-12 syllables spoken by the
   synthetic corpus' chord encoding, 406 syllables, all in the 48 train
   utterances, 16 dev), and a 24-bit PCM copy of its WAVs (samples v *
   256), read by the native host runtime (`tpuasr_torch.utils.native`):
   every train and dev batch of the copy is the 16-bit corpus's bit for
   bit; `split_data` and `gen_vocab` (406 syllables, so 412 tokens); the
   trainer with --data_root on the 24-bit copy for one epoch at its card
   defaults plus `fused_ffn=True` (finite losses); host ms to read the
   trainer's batch by `read_wav`, native `wav_read` and `BatchLoader(8)`
   (recorded, no gate); the checkpoint's blank logits (joint and
   CTC head) fitted on the CPU as phases 4 and 4b fit them and written back;
   `evaluate` on the dev split in the five transducer modes and
   `eval_streaming`, each on the card and with `--device cpu`, both in
   fp32 over the checkpoint's fbank precision ("default"): rnnt_greedy,
   ctc_greedy and streaming greedy give the same hypotheses and S/D/I/N,
   as do rnnt_greedy and ctc_greedy on the card over the 24-bit copy,
   each beam mode follows phase 4b's 2d rule on the n-best lists its
   searches returned inside the CLI calls, and the CPU's hypotheses are the
   best of its own lists; `decode_stream` on a dev WAV whose encoder frames
   are not whole chunks: its last greedy line is `streaming_greedy_decode`
   of the WAV, its cand 1 `streaming_beam_decode`'s best, and the same
   chunk loop without the gate at the WAV's end must extend its greedy
   hypothesis (the trailing tokens the gate keeps out are printed;
   eval_streaming's hypothesis of that utterance is printed beside it: in
   its padded batch the last chunk attends to other padding). Each CLI's
   wall and launches are printed beside the card's name and power limit;
   the run (counts reset before split_data, read after decode_stream) must
   launch every kernel, fbank by its tensor-core route alone, #1, #2 and
   #10 while serving and #8 in rnnt_rescoring; each kernel is held against
   its plain version on the arguments the run gave it at every signature,
   the signature launched most timed.
10. The CTC workload and the trainer's options. The CTC run (counts reset
   before 10a, read after 10c; it must launch fbank by its tensor-core
   route, #6 and #7 by their warp routes, and nothing else; each kernel is
   then held against its plain version on the run's own recorded inputs, as
   phase 9 holds its, the signature launched most timed):
   a. `CTCModel` at CTCModelConfig's defaults (conv2d8, d256, 8 heads, 3
      blocks, FFN 1024, conv 31; 412 tokens, blank 5, seeded weights, fp32)
      on bench.py's 12 waves: one training step on the card and on the CPU
      from the same features (the card's fbank at "default", copied), no
      dropout: losses, every gradient leaf and the GuardedAdam step held as
      6a holds them;
   b. `python -m tpuasr_torch.tools.train --workload ctc` in this process at
      the card's defaults on the hard synthetic corpus cut as phase 8 cuts
      it, 2 epochs and a `--resume` for a third: finite losses, no skipped
      step, the resume at the saved epoch and step; each step synced and
      timed (median wall, audio-s/s), then one profiled step of the resumed
      model (device busy ms, idle share);
   c. `ctc_greedy_decode` and `ctc_forced_align` on the card and on the CPU
      from the card's log-probs of 10a: tokens and alignments identical,
      Viterbi scores within 1e-6; each side's own model's greedy hypotheses
      compared (printed);
   d. the flagship at 6b's configuration, in fp32 and in bf16, one forward
      and backward with `encoder.gradient_checkpointing` off, on and off
      again from the same generators, with `fused_ffn` off and on: loss
      within 1e-4 relative, every gradient leaf within 1e-3 of its max in
      fp32 and 2**-6 of it in bf16 (two bf16 steps: a step comes and goes
      between two flag-off runs, whose spread is printed; the key
      projections' biases, no gradient in exact arithmetic, within 1e-3 of
      the largest entry), the flag's peak memory below the run without it, and #2 (and #10 with the fused FFN) launched twice as
      often with it (the recompute);
   e. four steps at 6b's configuration with `optim.accum_steps=2` and
      attention dropout 0.1: finite losses, the weights unchanged after
      micro-steps 1 and 3 and moved after 2 and 4, the Adam count 2, and
      #2/#3 never launched (attention dropout takes the plain route).
11. The AED workload: the hybrid CTC/attention `ASRModel` at the repo's own
   defaults (the non-causal rel-pos conformer of EncoderConfig: 12 blocks,
   d256, 4 heads, FFN 1024, conv 31, conv2d subsampling; a 6-block
   transformer decoder, 4 heads, FFN 1024; 412 tokens, blank 5, sos 2, eos
   3, ctc_weight 0.3, lsm_weight 0.1; `fused_attention`, fbank "default"),
   built and seeded by the trainer's `build_model`. The AED run (counts
   reset before 11a, read after 11c; it must launch fbank by its
   tensor-core route, #2, #3, #6 and #7, and nothing else; each kernel is
   then held against its plain version on the run's own recorded inputs,
   as phase 10 holds its, the signature launched most timed):
   a. one fp32 training step, no dropout, on the card and on the CPU from
      the same features (the card's fbank of the first 4 of bench.py's 12
      waves, copied): the losses, every gradient leaf and the GuardedAdam
      step held as 6a holds them (the self- and cross-attention key biases
      against the largest gradient entry), th_accuracy within one token;
   b. `python -m tpuasr_torch.tools.train --workload aed` in this process
      at the card's defaults (bf16) on the hard synthetic corpus cut as
      phase 8 cuts it, 2 epochs and a `--resume` for a third: finite
      losses, no skipped step, the resume at the saved epoch and step, each
      step synced and timed, one profiled step;
   c. `make_offline_decoder`'s four AED modes (ctc_greedy, ctc_prefix_beam,
      attention, attention_rescoring; beam 4, 24 tokens) on the fixture
      requests in fp32, card against CPU: the CTC head's blank logit fitted
      as in 4b, the decoder's <eos> logit so that the attention beam's best
      hypotheses average 12 tokens (a quarter to three quarters of 24
      required); ctc_greedy tokens identical, each beam mode by 4b's 2d rule
      on its n-best lists, each entry point giving its search's best, each
      mode's latency, the attention search's steps and device busy ms
      (profiler); then a model with a 3-block R2L decoder (reverse
      weight 0.3) through attention_rescoring by the same rule.
12. The transducer's other options, each the online_rnnt flagship with
   only the fields of `ZOO` changed (its depth among them: CUT_BLOCKS, 6
   of the 12 blocks, at full width), seed-0 weights. The zoo run (counts
   reset before 12a, read after 12c) must launch every kernel, fbank by its
   FFT and tensor-core routes alone; each kernel is then held against its
   plain version on the run's own recorded inputs, the signature launched
   most timed:
   a. the stateless pruned transducer (the embedding predictor, history 2,
      4 heads; `rnnt_prune_range` 5; fused attention and FFN): one fp32
      training step card against CPU as 6a holds it; the trainer
      (`--workload online_rnnt`, the card's bf16 defaults, one epoch of the
      hard corpus cut as phase 8 cuts it) at `rnnt_prune_range` 5 and, for
      comparison, 0 (the fused joint loss): the median step, audio-s/s, the
      peak memory and one profiled step's device ms each; serving in fp32
      on the fixture requests: rnnt_greedy tokens identical card vs CPU,
      rnnt_beam and rnnt_rescoring by 4b's 2d rule, streaming greedy ==
      chunk-masked offline on the card;
   b. the zoo transducer (RoPE with 2 K/V heads, no positional table, MoE
      FFNs of 8 experts with 2 active, RMS-normed conv modules, the conv
      predictor, a HAT joint, which takes the materialized loss): one fp32
      step card vs CPU; a bf16 step at bench.py's configuration and batch,
      profiled (device ms, operations, peak memory); rnnt_greedy identical, rnnt_beam by the 2d rule,
      streaming == chunk-masked offline;
   c. full context (FireRed's front end and attention, gated FFNs, batch
      norm in evaluation with seeded running statistics, a post-join
      linear): rnnt_greedy identical and rnnt_beam by the 2d rule.
   Then, outside the counted run, the pruned, fused and materialized losses
   alone at bench.py's shape: forward and backward wall and peak memory.
13. The encoder families, each the online_rnnt flagship with the family's
   fields (FAMILIES; the JAX `EncoderConfig` defaults of each family's own
   fields). The families run (counts reset before 13a, read after 13c)
   must launch #1 (fbank by its tensor-core route in training and its FFT
   in serving, never the dense one) and #4-#9, and never #2, #3, #10 or
   #11: the families' attention and FFNs are plain in the JAX package
   whatever fused_attention and fused_ffn say; each kernel is then held
   against its plain version on the run's own recorded inputs:
   a. squeezeformer (reduce at block 5, recover at 11, the "stream" time
      reduction) and the efficient conformer (a stride after block 3,
      groups of 3): one fp32 training step card against CPU through each
      loss route, as 6a holds it (the grouped attention's key bias is a
      weight where a block's frames do not fill whole groups);
   b. the trainer (`--workload online_rnnt`, the card's bf16 defaults, one
      epoch of the hard corpus) for each: median step, audio-s/s, peak
      memory and one profiled step's device ms;
   c. fp32 serving on the fixture requests for each: rnnt_greedy identical
      card vs CPU, rnnt_beam, ctc_prefix_beam and rnnt_rescoring by 4b's
      2d rule; streaming greedy and beam == chunk-masked offline on the
      card (squeezeformer chunk 32 and 6 left chunks, the efficient
      conformer chunk 24 and 8: its chunk emits 12 frames) over the whole
      chunks of each request's valid frames; streaming greedy RTF p50/p90
      on the synthetic batch. The non-causal squeezeformer with the "conv"
      reduction, which the caches refuse: the same offline modes, and
      prefix recomputation of a seeded 60 s request (chunk 32, the
      receptive field's look-ahead) equal to the chunk-masked full forward
      over every frame it emitted.
14. The Paraformer workload at the repo's defaults, as the trainer builds
   it (`paraformer_config`): 412 tokens, max 64, <eos> 3, the CIF head
   (tail threshold 0.45, dropout 0.1), the glancing sampler at 0.75, a
   6-block NAR decoder (4 heads, FFN 1024); the conformer stack of
   EncoderConfig's defaults (12 non-causal rel-pos blocks, d256, conv 31,
   `fused_attention`) with the TransformerDecoder over the fired
   embeddings, or the SANM stack (LFR 7/6, 12 SANM blocks at d256, FSMN
   kernel 11, the SANM decoder). The paraformer run (counts reset before
   14a, read after 14c) must launch #1 (its tensor-core route in training,
   the FFT in serving), #2, #3, #6 and #7 and nothing else; the conformer
   stack's trainer #1, #2 and #3; 14a's CTC-branch step #6 and #7; the SANM
   stack's parts none of #2, #3, #10, #11 (each part's launches from the
   counts' deltas); each kernel is then held against its plain version on
   the run's own recorded inputs, the signature launched most timed:
   a. one fp32 training step card vs CPU on 6a's batch, no dropout, the
      sampler on the same seeded scores on both sides, for the conformer
      stack, the conformer stack with `ctc_weight=0.3` and
      `timestamp_branch=True`, and the SANM stack: held as 6a holds a step;
   b. `python -m tpuasr_torch.tools.train --workload paraformer` in this
      process at the card's defaults (bf16, fbank "default"), one epoch of
      the hard corpus cut as phase 8 cuts it, for each stack: finite
      losses, no skipped step, the median step, audio-s/s, the peak memory
      and one profiled step's device ms;
   c. fp32 serving of the 16 fixture requests for each stack, card vs CPU,
      the CIF output bias fitted to the transcripts' tokens a frame (at
      random weights the weights sit near 0.5 and the counts clip at 64):
      CIF's floors (the counts, floor of the weights' sum, and the peaks,
      the cumsum's floor-crossings) are not continuous, so they are held
      by a margin rule: d = the largest |card - CPU| of the fired weights'
      cumsum and sum, and every row whose CPU distance to the nearest
      integer exceeds 2d must give the same count (peaks: over its
      cumsum); greedy tokens identical where the counts agree, the fire
      frames where the peaks are held, `paraformer_beam` (beam 10) by 4b's
      2d rule on those rows; `make_offline_decoder` in both modes gives
      the model's own search; each mode's latency; `evaluate` in both
      modes on a checkpoint of these weights (its wall).
15. Whisper at WhisperConfig's defaults: 412 tokens, 2 languages, a
   6-block decoder (4 heads, FFN 1024), the conformer of EncoderConfig's
   defaults (12 non-causal rel-pos blocks, d256, conv 31) with
   `fused_attention` and `fused_ffn`; fp32, the fixture requests' fbank
   ("highest"), each request's task and language in turn (transcribe,
   translate, VAD; both languages). The whisper run (counts reset before
   15a, read after 15c) must launch #1 by its FFT route, #2, #3, #10 and
   #11 and nothing else; each kernel is then held against its plain
   version on the run's own recorded inputs:
   a. one loss + backward + GuardedAdam step card vs CPU on the first 4
      requests' features and seeded labels, held as 6a holds a step;
   b. the decoder's eot logit fitted so that greedy hypotheses average
      half of 24 tokens, then `whisper_greedy_decode` card vs CPU: tokens
      identical;
   c. `whisper_beam_decode` (beam 4) by 4b's 2d rule on the n-best lists;
      the latency of the encoder, greedy and beam on the card.
16. The serving export of the flagship with `fused_ffn` (fp32, chunk
   CHUNK, LEFT left chunks, the fitted blank logit of phase 4):
   `export_streaming` for the 16 fixture streams on the card (the emission
   loop's depth cut to n_steps 3 to keep the trace short), saved and
   loaded (`load_exported`); the loaded `process_chunk` chained over every
   chunk of the fixture requests and of the same requests played eight
   times over (past the attention cache's capacity): tokens identical to
   `streaming_greedy_decode` on the card, as are the eager `process_chunk`
   with and without `sync_free`; the export run (the artifact's chunks,
   counts reset before and read after) launches #10 24 times a chunk and
   nothing else, and #10 is held against its plain version on the inputs
   the artifact gave it; the per-chunk latency of the artifact against
   the eager paths; `tools/export_stream --verify` on the card at one
   block, d64.
17. The parallel layer (`tpuasr_torch.parallel`). Two ranks of this script
   (`--parallel-rank`) on cuda:0 over gloo (NCCL refuses two ranks on one
   device; with two cards the same run also goes over NCCL on cuda:0 and
   cuda:1), each probing which collectives gloo takes on CUDA tensors, then,
   with every count reset before and read after (the parallel run): one
   fp32 step of phase 6a's flagship on bench.py's 12 rows, 6 a rank, at
   ZeRO stages none, zero1 and zero3 (the fused joint loss: #1-#9 must
   launch) and with `model.shard_joint` on a 1 x 2 mesh (the materialized
   loss, the vocabulary split: #8/#9 and not #4/#5) for the plain head, the
   HAT (`joint.hat_joint`) and a post-join linear (`joint.postjoin_linear`),
   each held against the
   same step at one rank on the card by 6a's rule (losses 1e-4 relative,
   every gradient leaf 1e-3 of its max, GuardedAdam alone on the ranks'
   reduced gradients and end to end); streaming greedy of the fp32
   flagship on the 16 fixture requests split over the ranks
   (`make_sharded_streaming_decode`): tokens identical to one rank's. Every
   wrapper call on the card must be a launch (no plain fallback); rank 0
   holds each kernel against its plain version on the run's own inputs;
   `tools/tp_joint_bench.analyze` prints each rank's peak memory for the
   joint, loss and gradients at B8 T512 U128 V4096 (8.66 GB of logits)
   unsharded and at tp 2. Each step records its collectives
   (`parallel.scaling.record_collectives`): the "none" step's gradient
   all-reduce must carry the flat gradient's bytes plus the metrics
   vector's, and `parallel.scaling` costs every case's records laid over 8
   GPUs a host at 1, 2 and 4 hosts (a split case with the "none" step's
   data-axis collectives added), against 6b's median step and its device
   busy ms, at the assumed NVLink and NIC rates. `python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m
   tpuasr_torch.tools.train` trains an epoch under NCCL at world size 1,
   beside the one-rank reference steps (no timing reads them) and done
   before the ranks start.
18. A JAX-layout checkpoint on the card (every count reset before, read
   after: the jax_checkpoint run). Phase 8's full-width checkpoint (after
   its resume) written as the JAX package's `TrainState` tree
   (`convert.flax_train_state`: the flax params, the Adam moments in their
   layout, count, step, lr_scale, skipped) into the npz that
   `tools/orbax_to_npz` writes of an orbax directory, with its info JSON
   and train.yaml beside it. Restored through `train.restore_checkpoint`,
   every tensor of the model and the optimizer state equals the port
   checkpoint's bit for bit; `evaluate --mode rnnt_greedy` and
   `eval_streaming` on phase 9's corpus print the same CER lines and
   hypotheses given the npz as given the port checkpoint;
   `tools/campaign_eval` over the npz exits 0; `tools/train --resume` for one
   epoch from the npz and from the port checkpoint starts at the saved
   epoch and step, first-step losses within 6a's 1e-4 relative; then the
   profiling tools at bench.py's configuration: `profile_step`,
   `batch_sweep` (batches 12 and 24) and `profile_trace` (5 steps,
   --fused), whose Chrome trace must name every hand kernel that 6b's
   profiled step ran (a plain version on that path fails the run).
7. The kernels line: one JSON object with an entry per kernel and run
   (the serving run of phases 4-5b, the training runs of phases 6b, 6c and
   6d, the trainer run of phase 8, the corpus run of phase 9, the CTC run
   of phase 10, the AED run of phase 11, the zoo run of phase 12, the
   families run of phase 13, the paraformer run of phase 14, the whisper
   run of phase 15, the export run of phase 16, the parallel run of phase
   17, whose launches are both ranks' and records rank 0's, the
   jax_checkpoint run of phase 18; counts
   reset just before each and read just after): that run's launches
   (fbank's: those of the route the record times, the FFT for serving,
   which takes that route alone, and the tensor-core route for training,
   which never takes the FFT), and the error, times and bound at the shape
   that run gives the kernel (phase 3's bench-shape records for 6b-6d; for
   the trainer, the corpus, CTC, AED, zoo, families, paraformer, whisper,
   export and jax_checkpoint runs and #8 in serving the signature it
   launched most, with
   every signature's
   record under "shapes"). The CTC and RNN-T lattice entries carry their
   run's launches by route under "routes": each run that launches a
   lattice must take its warp route alone.

Each phase prints its seconds.
TF32 is off throughout (cuBLAS and cuDNN), so every fp32 comparison is fp32.
The last line is {"ok": true, "device": {...}}. The script imports nothing
of JAX: the machine with the card need not have it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_FP32 = 67e12    # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor cores, FLOP/s
PEAK_TF32 = 494.7e12  # H100 SXM dense TF32 tensor cores, FLOP/s (3xTF32: three passes)
HBM_BPS = 3.35e12    # H100 SXM HBM3, bytes/s
SEED = 0
SLEEP_CYCLES = 50_000_000  # ~25 ms of GPU clock, the floor; sized up from one timed enqueue
CHUNK, LEFT = 32, 6
# phase 12 runs its models at full width and half the flagship's depth, so
# that the script keeps inside its time limit with phase 18
CUT_BLOCKS = 6


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card to drive")
    sys.path.insert(0, str(ROOT))
    try:
        import tpuasr_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script: {e}")
    require((ROOT / "fixtures" / "example1.npz").exists(), "fixtures/example1.npz missing")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 1
    print("== phase 1: device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off (matmul, cudnn)")
    from tpuasr_torch.ops._build import _nvcc

    nv = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("nvcc:", nv.stdout.strip().splitlines()[-1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)

    # ---------------------------------------------------------------- 2
    print("== phase 2: build")
    from tpuasr_torch.ops import build_all

    t0 = time.perf_counter()
    logs = build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = _kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")

    # ---------------------------------------------------------------- 3
    t_phase = _phase("3: kernels against their plain versions", t0)
    from tpuasr_torch.config import Config
    from tpuasr_torch.tools.profile_trace import bench_batch

    data = _requests()
    # bench.py's batch (bench.py:83-90): 12 utterances of 24-30 content
    # tokens plus SOS and EOS, padded to (768 - 1) * hop samples and 32 tokens
    bench = bench_batch(Config(), dev, BENCH_B, BENCH_FRAMES, BENCH_TOKENS)
    print(f"bench.py's batch: {BENCH_B} waves of {bench['waves'].shape[1]} samples, "
          f"{float(bench['wave_lens'].sum()) / SR:.2f} s of audio, label lengths "
          f"{bench['text_lens'].tolist()}")
    checks = _kernel_checks(torch, dev, data, bench)
    checks.update(_attention_train_checks(torch, dev, bench))
    train_checks, fwd_plans = _train_kernel_checks(torch, dev, bench)
    checks.update(train_checks)
    rnnt_sweep = _rnnt_route_sweep(torch, dev)
    checks.update(_ffn_checks(torch, dev))

    # ---------------------------------------------------------------- 4-5
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts

    t_phase = _phase("4-5: serving", t_phase)
    reset_launch_counts()
    with _recording(torch, only=("rnnt_alpha",)) as seen:
        serving, served = _serve(torch, dev, data)
        serving["modes"] = _serve_modes(torch, dev, data, served)
        serving["stream_beam"] = _serve_stream_beam(torch, dev, data, served)
    runs = {"serving": dict(LAUNCHES)}
    print(f"launches on the serving run: {runs['serving']}")
    require(runs["serving"]["ffn_bwd"] == 0, "the serving run launched the FFN backward")
    require(runs["serving"]["fbank_fft"] == runs["serving"]["fbank"] > 0,
            "the serving run did not take fbank's FFT route (precision \"highest\") alone")
    for name in ("rnnt_beta_grad", "ctc_alpha", "ctc_beta_grad"):
        require(runs["serving"][name] == 0, f"the serving run launched {name}")
    require(runs["serving"]["rnnt_alpha_warp"] == runs["serving"]["rnnt_alpha"] > 0,
            "rnnt_rescoring did not launch #8 by its warp route alone")
    print("#8 against its plain version on the inputs rnnt_rescoring gave it:")
    checks["rnnt_alpha_serving"] = _serving_lattice_record(torch, seen, runs["serving"])
    gpu32, cfg32, blank_bias = served["gpu32"], served["cfg32"], served["bias"]
    serving["offline_device_busy_ms_by_fbank_route"] = _fbank_route_ab(
        torch, gpu32, cfg32, *data["fixture"])
    del gpu32, served

    # ---------------------------------------------------------------- 6
    training = {"rnnt_fused_fwd_plans": fwd_plans,  # counted from the shapes, not measured
                "rnnt_lattice_by_route": rnnt_sweep}
    for fused, ffn in ((True, False), (False, False), (True, True)):
        t_phase = _phase(f"6a: training step, card against CPU (fp32, fused_joint_loss="
                         f"{fused}, fused_ffn={ffn})", t_phase)
        training[f"card_vs_cpu_fused_joint_loss_{fused}" + ("_fused_ffn" if ffn else "")] = \
            _train_card_vs_cpu(torch, dev, fused, ffn)
    t_phase = _phase("6b: training at bench.py's configuration", t_phase)
    training["bench"], runs["training"] = _train_bench(torch, dev, bench, True)
    print(f"launches on the training run: {runs['training']}")
    for kind in ("ctc", "rnnt"):
        training["bench"][f"device_busy_ms_by_{kind}_route"] = _lattice_route_ab(
            torch, dev, bench, kind)
    t_phase = _phase("6c: training through the materialized loss", t_phase)
    training["bench_materialized"], runs["training_materialized"] = _train_bench(
        torch, dev, bench, False, n_steps=4, warmup=1)
    print(f"launches on the materialized training run: {runs['training_materialized']}")
    t_phase = _phase("6d: training at bench.py's configuration with fused_ffn=True", t_phase)
    training["bench_fused_ffn"], runs["training_fused_ffn"] = _train_bench(
        torch, dev, bench, True, fused_ffn=True)
    print(f"launches on the fused-FFN training run: {runs['training_fused_ffn']}")
    _compare_steps(training["bench"], training["bench_fused_ffn"])
    steps_6d = len(training["bench_fused_ffn"]["losses"])
    for name in KERNELS:
        require(runs["training_fused_ffn"][name] > 0, f"the 6d run never launched {name}")
    for name in ("ffn_fwd", "ffn_bwd"):
        require(runs["training_fused_ffn"][name] == 24 * steps_6d,
                f"6d launched {name} {runs['training_fused_ffn'][name]} times, not 24 per step")

    # ---------------------------------------------------------------- 8
    t_phase = _phase("8: the trainer (tpuasr_torch.tools.train), 2 epochs and a resume",
                     t_phase)
    (ROOT / "build").mkdir(exist_ok=True)
    # phase 8's checkpoint and phase 9's corpus, kept for phase 18
    work = tempfile.TemporaryDirectory(prefix="smoke-", dir=ROOT / "build")
    kept = {k: f"{work.name}/{k}" for k in ("trainer", "corpus")}
    for d in kept.values():
        Path(d).mkdir()
    training["trainer"], runs["trainer"], seen = _trainer(torch, kept["trainer"])
    print(f"launches on the trainer run: {runs['trainer']}")
    for name in KERNELS:
        require(runs["trainer"][name] > 0, f"the trainer never launched {name}")
    require(runs["trainer"]["fbank_tc"] == runs["trainer"]["fbank"]
            and runs["trainer"]["fbank_fft"] == 0,
            "the trainer did not take fbank's tensor-core route (precision \"default\") alone")
    print("kernels against their plain versions on the trainer's own inputs:")
    trainer_records = _trainer_kernel_records(torch, seen, runs["trainer"], timed=1)

    # ---------------------------------------------------------------- 9
    t_phase = _phase("9: the corpus on disk and the serving CLIs", t_phase)
    corpus, runs["corpus"], parts = _corpus(torch, card, kept["corpus"])
    print(f"launches on the corpus run: {runs['corpus']}; wrapper calls on the card that "
          f"launched nothing: {[seen.get('idle', {}) for seen, _ in parts.values()]}")
    for name in KERNELS:
        require(runs["corpus"][name] > 0, f"the corpus run never launched {name}")
    require(runs["corpus"]["fbank_tc"] == runs["corpus"]["fbank"]
            and runs["corpus"]["fbank_fft"] == 0,
            "the corpus run did not take fbank's tensor-core route (precision \"default\") alone")
    print("kernels against their plain versions on the corpus run's own inputs:")
    corpus_records = _corpus_kernel_records(torch, parts)

    # ---------------------------------------------------------------- 10
    t_phase = _phase("10a: the CTC workload, a training step card against CPU", t_phase)
    ctc = {}
    reset_launch_counts()
    with _recording(torch) as seen:  # the CTC run, 10a-10c
        ctc["card_vs_cpu"], lps = _ctc_card_vs_cpu(torch, dev, bench)
        t_phase = _phase("10b: the trainer, --workload ctc, 2 epochs and a resume", t_phase)
        ctc["trainer"] = _ctc_trainer(torch, dev)
        t_phase = _phase("10c: CTC greedy decoding and forced alignment, card against CPU",
                         t_phase)
        ctc["decode_align"] = _ctc_decode_align(torch, dev, lps, bench)
    runs["ctc"] = dict(LAUNCHES)
    print(f"launches on the CTC run (10a-10c): {runs['ctc']}")
    for name in KERNELS:
        on_path = name in ("fbank", "ctc_alpha", "ctc_beta_grad")
        require((runs["ctc"][name] > 0) == on_path,
                f"the CTC run launched {name} {runs['ctc'][name]} times")
    require(runs["ctc"]["fbank_tc"] == runs["ctc"]["fbank"],
            "the CTC run did not take fbank's tensor-core route (precision \"default\") alone")
    print("kernels against their plain versions on the CTC run's own inputs:")
    ctc_records = _trainer_kernel_records(torch, seen, runs["ctc"], "ctc", timed=1)
    t_phase = _phase("10d: gradient checkpointing at 6b's configuration", t_phase)
    ctc["gradient_checkpointing"] = _remat_check(torch, dev, bench)
    t_phase = _phase("10e: gradient accumulation and attention dropout at 6b's configuration",
                     t_phase)
    ctc["accumulation"] = _accum_check(torch, dev, bench)

    # ---------------------------------------------------------------- 11
    t_phase = _phase("11a: the AED workload, a training step card against CPU", t_phase)
    aed = {}
    reset_launch_counts()
    with _recording(torch) as seen:  # the AED run, 11a-11c
        aed["card_vs_cpu"] = _aed_card_vs_cpu(torch, dev, bench)
        t_phase = _phase("11b: the trainer, --workload aed, 2 epochs and a resume", t_phase)
        aed["trainer"] = _aed_trainer(torch, dev)
        t_phase = _phase("11c: the AED decode modes, card against CPU", t_phase)
        aed["decode"] = _aed_decode(torch, dev, data)
    runs["aed"] = dict(LAUNCHES)
    print(f"launches on the AED run (11a-11c): {runs['aed']}")
    for name in KERNELS:
        on_path = name in ("fbank", "relpos_attention", "relpos_attention_bwd", "ctc_alpha",
                           "ctc_beta_grad")
        require((runs["aed"][name] > 0) == on_path,
                f"the AED run launched {name} {runs['aed'][name]} times")
    require(runs["aed"]["fbank_tc"] == runs["aed"]["fbank"],
            "the AED run did not take fbank's tensor-core route (precision \"default\") alone")
    print("kernels against their plain versions on the AED run's own inputs:")
    aed_records = _trainer_kernel_records(torch, seen, runs["aed"], "aed", timed=1)

    # ---------------------------------------------------------------- 12
    t_phase = _phase("12: the transducer's other options (12a stateless pruned, 12b zoo, "
                     "12c full context)", t_phase)
    reset_launch_counts()
    with _recording(torch) as seen:  # the zoo run, 12a-12c
        zoo = _zoo_phase(torch, dev, data, bench)
    runs["zoo"] = dict(LAUNCHES)
    print(f"launches on the zoo run (12a-12c): {runs['zoo']}")
    for name in KERNELS:
        require(runs["zoo"][name] > 0, f"the zoo run never launched {name}")
    require(runs["zoo"]["fbank_fp32"] == 0, "the zoo run took fbank's dense fp32 route")
    print("kernels against their plain versions on the zoo run's own inputs:")
    zoo_records = _trainer_kernel_records(torch, seen, runs["zoo"], "zoo", timed=1)
    zoo["loss_routes"] = _loss_routes(torch, dev, bench)
    print(f"(phase 12: {time.perf_counter() - t_phase:.1f} s)")

    # ---------------------------------------------------------------- 13
    t_phase = _phase("13: the encoder families (13a steps card vs CPU, 13b the trainer, "
                     "13c serving, streaming and prefix recomputation)", t_phase)
    families, runs["families"], families_records = _families_run(torch, dev, data)
    print(f"(phase 13: {time.perf_counter() - t_phase:.1f} s)")

    # ---------------------------------------------------------------- 14
    t_phase = _phase("14: the Paraformer workload (14a steps card vs CPU, 14b the trainer, "
                     "14c serving and the evaluate CLI)", t_phase)
    para, runs["paraformer"], para_records = _para_run(torch, dev, data)
    print(f"(phase 14: {time.perf_counter() - t_phase:.1f} s)")

    # ---------------------------------------------------------------- 15
    t_phase = _phase("15: Whisper (15a a step card vs CPU, 15b greedy, 15c beam and "
                     "latency)", t_phase)
    whisper, runs["whisper"], whisper_records = _whisper_run(torch, dev, data)

    # ---------------------------------------------------------------- 16
    t_phase = _phase("16: the serving export (torch.export artifacts of the streaming "
                     "surface)", t_phase)
    export, runs["export"], export_records = _export_phase(torch, dev, data, blank_bias)

    # ---------------------------------------------------------------- 17
    t_phase = _phase("17: the parallel layer (2 ranks over gloo on the card against one rank; "
                     "the trainer under torchrun, NCCL)", t_phase)
    parallel, runs["parallel"], parallel_records = _parallel_phase(
        torch, dev, data, bench, blank_bias, card, training["bench"]["step_ms_median"],
        training["bench"]["profiled_step_device_busy_ms"])
    print(f"launches on the parallel run (both ranks): "
          f"{ {k: v for k, v in runs['parallel'].items() if v} }")

    # ---------------------------------------------------------------- 18
    t_phase = _phase("18: a JAX-layout checkpoint on the card (restore, serving CLIs, "
                     "campaign_eval, resume, the profiling tools)", t_phase)
    reset_launch_counts()
    with _recording(torch) as seen:
        jax_ckpt = _jax_checkpoint_phase(torch, dev, kept["trainer"], kept["corpus"],
                                         training["bench"]["port_kernels_ms"])
    runs["jax_checkpoint"] = dict(LAUNCHES)
    work.cleanup()
    print(f"launches on the jax_checkpoint run: {runs['jax_checkpoint']}")
    for name in KERNELS:
        require(runs["jax_checkpoint"][name] > 0, f"the jax_checkpoint run never launched {name}")
    print("kernels against their plain versions on the jax_checkpoint run's own inputs:")
    jax_records = _trainer_kernel_records(torch, seen, runs["jax_checkpoint"], "jax_checkpoint",
                                          timed=1)
    print(f"(phase 18: {time.perf_counter() - t_phase:.1f} s)")

    # ---------------------------------------------------------------- 7
    # one entry per kernel and run that launches it, with the record taken
    # at the shape that run gives it: 6b, 6c and 6d give the same shapes
    # (bench.py's batch, phase 3's records); the trainer's records are taken
    # on its own inputs, at the signature it launched most, every
    # signature's under "shapes"
    _phase("7: the kernels line", t_phase)
    fused = ("training", "training_fused_ffn", "trainer", "corpus")  # the fused joint loss
    every = fused[:1] + ("training_materialized",) + fused[1:]
    with_ctc = every + ("ctc",)  # the kernels of the CTC workload's run
    # the AED run launches #1, #2, #3, #6 and #7
    # (kernel, runs, record, launch count): fbank's records count the route
    # they time, "highest" by the FFT for serving and the tensor-core route
    # for training
    plan = [("fbank", ("serving",), "fbank", "fbank_fft"),
            ("fbank", with_ctc + ("aed",), "fbank_training", "fbank_tc"),
            ("relpos_attention", ("serving",), "attention"),
            ("relpos_attention", every + ("aed",), "attention_training"),
            ("relpos_attention_bwd", every + ("aed",), "attention_bwd"),
            ("rnnt_fused_fwd", fused, "rnnt_fused_fwd"),
            ("rnnt_fused_bwd", fused, "rnnt_fused_bwd"),
            ("ctc_alpha", with_ctc + ("aed",), "ctc_alpha"),
            ("ctc_beta_grad", with_ctc + ("aed",), "ctc_beta_grad"),
            ("rnnt_alpha", ("serving",), "rnnt_alpha_serving"),
            ("rnnt_alpha", every, "rnnt_alpha"), ("rnnt_beta_grad", every, "rnnt_beta_grad"),
            ("ffn_fwd", ("serving",), "ffn_fwd_serving"),
            ("ffn_fwd", fused[1:], "ffn_fwd"), ("ffn_bwd", fused[1:], "ffn_bwd")]
    # the zoo run (phase 12) launches every kernel: its records at the
    # signature it launched most
    plan += [(name, ("zoo",), name) for name in KERNELS]
    # the families run (phase 13) launches #1 and #4-#9
    plan += [(name, ("families",), name) for name in KERNELS if runs["families"][name] > 0]
    # the paraformer run (phase 14) launches #1, #2, #3, #6 and #7
    plan += [(name, ("paraformer",), name) for name in KERNELS if runs["paraformer"][name] > 0]
    # the whisper run (phase 15) launches #1, #2, #3, #10 and #11; the export
    # run (phase 16's loaded process_chunk) #10 alone
    plan += [(name, ("whisper",), name) for name in KERNELS if runs["whisper"][name] > 0]
    plan += [("ffn_fwd", ("export",), "ffn_fwd")]
    # the parallel run (phase 17's ranks) launches #1-#9: its records are
    # rank 0's, its launches both ranks'
    plan += [(name, ("parallel",), name) for name in KERNELS if runs["parallel"][name] > 0]
    # the jax_checkpoint run (phase 18) launches every kernel
    plan += [(name, ("jax_checkpoint",), name) for name in KERNELS]
    kernels = []
    for name, run_names, check, *count in plan:
        count = count[0] if count else name
        for run in run_names:
            launches = runs[run][count]
            require(launches > 0, f"the {run} run never launched {count}")
            own = {"trainer": trainer_records, "corpus": corpus_records, "ctc": ctc_records,
                   "aed": aed_records, "zoo": zoo_records, "families": families_records,
                   "paraformer": para_records, "whisper": whisper_records,
                   "export": export_records, "parallel": parallel_records,
                   "jax_checkpoint": jax_records}
            rec = own[run][name] if run in own else checks[check]
            entry = dict(rec, run=run, launches=launches,
                         **{f"launches_{r}": runs[r][count] for r in runs})
            if name in ("ctc_alpha", "ctc_beta_grad", "rnnt_alpha", "rnnt_beta_grad"):
                # every run that launches a lattice: its warp route alone
                entry["routes"] = {f"{name}_{r}": runs[run][f"{name}_{r}"] for r in ("warp", "block")}
                require(entry["routes"][f"{name}_warp"] == launches
                        and entry["routes"][f"{name}_block"] == 0,
                        f"the {run} run did not take {name}'s warp route alone: {entry['routes']}")
            kernels.append(entry)
    require(runs["training_materialized"]["rnnt_fused_fwd"] == 0,
            "the materialized run launched the fused joint")
    print(f"phases took {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"corpus": corpus}))
    print(json.dumps({"ctc": ctc}))
    print(json.dumps({"aed": aed}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"families": families}))
    print(json.dumps({"paraformer": para}))
    print(json.dumps({"whisper": whisper}))
    print(json.dumps({"export": export}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"jax_checkpoint": jax_ckpt}))
    print(json.dumps({"kernels": kernels}))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def _phase(name: str, since: float) -> float:
    """Print the last phase's seconds and the next phase's name; -> now."""
    now = time.perf_counter()
    print(f"(previous phase: {now - since:.1f} s)")
    print(f"== phase {name}")
    return now


def _requests() -> dict:
    """The fixture requests (16 waves, 48 kHz, float16 on the wire, and
    their transcripts' token counts) and a seeded synthetic 8 s batch of 4
    requests."""
    import numpy as np

    fx = np.load(ROOT / "fixtures" / "example1.npz")
    r = np.random.default_rng(SEED)
    n = 8 * 48000
    t = np.arange(n) / 48000.0
    waves = np.stack([0.1 * np.sin(2 * np.pi * (200 + 150 * i) * t) * (1 + 0.5 * np.sin(t))
                      + 0.02 * r.standard_normal(n) for i in range(4)]).astype(np.float32)
    return {"fixture": (fx["waves"], fx["wave_lens"]), "text_lens": fx["text_lens"],
            "synthetic": (waves, np.array([n, int(6.5 * 48000), n, 5 * 48000], np.int32))}


def _time_ms(torch, fn, iters: int = 30, warmup: int = 3, method: str = "events") -> float:
    """Mean device time of fn over `iters` calls.

    method "events": CUDA events around the calls, queued behind a sleep
    kernel that holds the stream while the host enqueues all of them, so the
    events time the device's work back to back and not the host's launch
    rate (the wrappers take longer to launch than the small kernels run).
    The sleep is sized from one timed enqueue, and the run fails if the
    host's enqueue outlasted it. method "profiler": torch.profiler's sum of
    the device's kernel time per call, for calls that cannot be queued
    behind a sleep (they wait for the device, or 30 of them enqueue more
    launches than the launch queue holds: the plain CTC and RNN-T lattices
    loop over frames or diagonals, the plain attention backward is ~40
    launches, and F.ctc_loss copies its host lengths to the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if method == "profiler":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / iters
    require(method == "events", f"unknown timing method {method}")
    t0 = time.perf_counter()
    fn()
    one = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = max(SLEEP_CYCLES, int(3 * iters * one * 2e9))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    require(host_ms < sleep_ms, f"the host took {host_ms:.1f} ms to enqueue {iters} calls, "
                                f"longer than the {sleep_ms:.1f} ms sleep: the events would "
                                f"time the host")
    return ev[1].elapsed_time(ev[2]) / iters


def _kernel_checks(torch, dev, data, bench) -> dict:
    """fbank (#1) on the serving requests and on the training batch, and the
    attention forward (#2) at the serving shapes; -> {"fbank",
    "fbank_training", "attention"}: the records at the serving run's and
    the training run's calls."""
    from dataclasses import astuple

    from tpuasr_torch.audio.fbank import _operands, decode_wire, frame_signal
    from tpuasr_torch.config import FeatureConfig
    from tpuasr_torch.nn.masks import chunk_mask
    from tpuasr_torch.ops import fbank_frames, relpos_attention
    from tpuasr_torch.ops.fbank import _fbank_plan
    from tpuasr_torch.ops.ffn import _sm_count

    out = {}
    cfg = FeatureConfig()
    window, cos, sin, mel = _operands(astuple(cfg), str(dev))
    n_fft, n_freq, n_mels = cfg.n_fft, cfg.n_fft // 2 + 1, cfg.n_mels
    both = (("highest", PEAK_FP32), ("default", PEAK_BF16))
    # the serving requests in both precisions, and the training step's
    # batch (phase 6b: bench.py's 12 waves) in the precision it trains with
    for src, wire, precs in (("fixture", data["fixture"][0], both),
                             ("synthetic", data["synthetic"][0], both),
                             ("bench", bench["waves"], both[1:])):
        waves = decode_wire(torch.as_tensor(wire).to(dev))
        frames = frame_signal(waves, n_fft, cfg.hop_length, cfg.center)
        frames = frames.reshape(-1, n_fft).contiguous()
        for prec, peak in precs:
            args = dict(frames=frames, window=window, cos=cos, sin=sin, mel=mel,
                        amin=cfg.amin, precision=prec)
            rec = _hold(torch, "fbank", args, f"{src} {prec}")
            rows = frames.shape[0]
            if prec == "highest":  # the FFT route: its plan, work, bits, split and yardsticks
                rec.update(_fbank_fft_checks(torch, args, src == "fixture"))
            else:  # the tensor-core route's own work: padded bins, K and rows
                plan = _fbank_plan(rows, n_fft, n_freq, n_mels, _sm_count(dev.index))
                work = plan["dft_flops"]
                print(f"  the bf16 route's own work ({plan['k_pad']} K in tiles of "
                      f"{plan['k_tile']}, {plan['n_freq_pad']} bins, {plan['n_mels_pad']} mel "
                      f"columns) {work / 1e9:.2f} GFLOP = {work / peak * 1e3:.4f} ms at the bf16 "
                      f"peak; plan: {plan['frames_per_block']} frames and {plan['warps']} "
                      f"warps a block (tiles {plan['tiles']}), "
                      f"{plan['blocks']} blocks, {plan['blocks_per_sm']} an SM, "
                      f"{plan['waves']} waves, {plan['smem']} B shared, "
                      f"{plan['ws_bytes']} B scratch")
                if src != "synthetic":  # the plan's choice at 4,112 and 9,216 frames
                    rec["by_block_shape"] = _fbank_tiles(torch, args)
                if src == "bench":
                    a, b = fbank_frames(*args.values()), fbank_frames(*args.values())
                    require(torch.equal(a, b), "two calls of fbank's bf16 route differ")
                    print("  two calls bit-identical")
                    split = _device_split(torch, lambda: fbank_frames(*args.values()))
                    print("  device ms by kernel: " + "; ".join(
                        f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(),
                                                                    key=lambda x: -x[1])))
            if src == "fixture" and prec == "highest":  # the serving run's call
                out["fbank"] = rec
            if src == "bench":  # the training run's call
                out["fbank_training"] = rec

    g = torch.Generator().manual_seed(SEED)
    fp32 = {}
    for b, t, lens in ((4, 187, (187, 150, 187, 100)), (16, 63, None)):
        h, dk = 4, 64
        d = h * dk
        valid = torch.ones(b, t, dtype=torch.bool) if lens is None else \
            torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
        mask = valid[:, None, :] & chunk_mask(t, CHUNK, LEFT)[None]  # [B, T, T]
        mask[1, 5] = False  # a fully masked query row gives zeros
        mask = mask.to(dev)
        base = [torch.randn(*shape, generator=g) for shape in
                ((b, t, d), (b, t, d), (1, t, d), (b, t, d))]
        ub, vb = 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, p, v = (x.to(dev, dtype) for x in base)
            args = dict(q=q, k=k, p=p, v=v, u_bias=ub.to(dev, dtype), v_bias=vb.to(dev, dtype),
                        mask=mask, scale=1.0 / math.sqrt(dk), n_head=h)
            rec = _hold(torch, "relpos_attention", args, "serving")
            require(bool((relpos_attention(*args.values())[1, 5] == 0).all()),
                    "a fully masked query row did not give zeros")
            if dtype == torch.float32:  # phase 4's fp32 serving calls
                fp32[f"[{b}, {t}, {d}]"] = rec
            elif b == 4:  # the flagship's 8 s bf16 call
                out["attention"] = rec
    out["attention"]["fp32_serving"] = fp32
    return out


def _fbank_fft_checks(torch, args, serving: bool) -> dict:
    """fbank's FFT route ("highest" at n_fft 1024) on `args`: print the
    plan and the design's own work (the FFT from the plan, the mel product
    over each filter's band of this mel matrix) and each route's max dB error
    against a float64 DFT on the card, and time it at each count of frames
    a block the plan could take; at the serving requests also two calls
    bit-identical, the device time by kernel, the dense kernel on the same
    frames (held against plain too) and torch.fft.rfft (cuFFT) of the
    windowed frames alone, one stage of the function; -> the measured
    numbers."""
    import tpuasr_torch.ops.fbank as fbank_mod
    from tpuasr_torch.ops.ffn import _sm_count

    frames, window, cos, sin, mel = (args[k] for k in ("frames", "window", "cos", "sin", "mel"))
    (rows, n_fft), (n_freq, n_mels) = frames.shape, mel.shape
    fft_plan, n_sm = fbank_mod._fbank_fft_plan, _sm_count(frames.device.index)
    plan = fft_plan(rows, n_fft, n_freq, n_mels, n_sm)
    require(plan["route"] == "fbank_fft", f"n_fft {n_fft} did not take the FFT route")
    nz = mel != 0
    f = torch.arange(n_freq, device=mel.device)[:, None]
    widths = (torch.where(nz, f, -1).max(0).values - torch.where(nz, f, n_freq).min(0).values
              + 1).clamp(min=0)
    work = plan["fft_flops"] + rows * (2 * int(widths.sum()) + 2 * n_mels)
    print(f"  the FFT design's own work {work / 1e6:.1f} MFLOP = {work / PEAK_FP32 * 1e3:.5f} ms "
          f"at the fp32 peak (FFT, split and power {plan['fft_flops'] / 1e6:.1f}, the mel "
          f"product over {int(widths.sum())} band bins of {n_freq * n_mels}); plan (counted, "
          f"not measured): {plan['frames_per_block']} frames of {plan['threads_per_frame']} "
          f"threads a block, {plan['points']} points a frame, {plan['points_per_thread']} a "
          f"thread, passes (lowest bit, bits) {plan['passes']}, {plan['blocks']} blocks, "
          f"{plan['blocks_per_sm']} an SM, {plan['waves']} waves, {plan['smem']} B shared")
    out = {}
    fw = frames.double() * window.double()
    exact = 10.0 * torch.log10(torch.clamp(((fw @ cos.double()) ** 2 + (fw @ sin.double()) ** 2)
                                           @ mel.double(), min=args["amin"]))
    out["fp64_max_db_err"] = {
        "fft": float((fbank_mod.fbank_frames(*args.values()).double() - exact).abs().max()),
        "plain": float((fbank_mod.fbank_frames_plain(*args.values()).double() - exact)
                       .abs().max())}
    print(f"  max dB error against a float64 DFT on the card: FFT kernel "
          f"{out['fp64_max_db_err']['fft']:.3g}, plain (fp32 products) "
          f"{out['fp64_max_db_err']['plain']:.3g}")
    by_frames = {}
    try:
        for fb in fbank_mod.FFT_FRAMES:
            try:
                fft_plan(rows, n_fft, n_freq, n_mels, n_sm, frames=fb)
            except ValueError:
                continue
            fbank_mod._fbank_fft_plan = lambda *a, fb=fb: fft_plan(*a, frames=fb)
            by_frames[fb] = _time_ms(torch, lambda: fbank_mod.fbank_frames(*args.values()))
    finally:
        fbank_mod._fbank_fft_plan = fft_plan
    out["by_frames_per_block_ms"] = by_frames
    print("  by frames a block (the plan's "
          f"{plan['frames_per_block']}), ms: " + "; ".join(f"{k}: {v:.4f}"
                                                         for k, v in by_frames.items()))
    if not serving:
        return out
    a, b = fbank_mod.fbank_frames(*args.values()), fbank_mod.fbank_frames(*args.values())
    require(torch.equal(a, b), "two calls of fbank's FFT route differ")
    require(bool((a[(frames == 0).all(1)] == -100.0).all()), "a silent frame is not at -100 dB")
    print("  two calls bit-identical; silent frames at -100 dB")
    split = _device_split(torch, lambda: fbank_mod.fbank_frames(*args.values()))
    out["device_split_ms"] = split
    print("  device ms by kernel (profiler): " + "; ".join(
        f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1])))
    try:  # the dense kernel at the same frames: the route a non-power-of-two takes
        fbank_mod._fbank_fft_plan = lambda r, *a: {"route": "fbank_fp32"}
        dense = fbank_mod.fbank_frames(*args.values())
        dense_err = float((dense - fbank_mod.fbank_frames_plain(*args.values())).abs().max())
        require(dense_err <= 2e-2, f"the dense kernel is {dense_err} dB off plain")
        out["dense_kernel_ms"] = _time_ms(torch, lambda: fbank_mod.fbank_frames(*args.values()))
    finally:
        fbank_mod._fbank_fft_plan = fft_plan
    print(f"  the dense kernel on the same frames (route fbank_fp32): "
          f"{out['dense_kernel_ms']:.4f} ms, max_abs_err against plain {dense_err:.3g}")
    fw32 = frames * window
    out["cufft_rfft_stage_ms"] = _time_ms(torch, lambda: torch.fft.rfft(fw32))
    print(f"  torch.fft.rfft (cuFFT) of the windowed frames alone, one stage of the function "
          f"(no window, power, mel or log): {out['cufft_rfft_stage_ms']:.4f} ms")
    return out


def _fbank_tiles(torch, args) -> dict:
    """fbank's bf16 route at each block shape the kernel builds (the plan
    fixed to it), to check the plan's choice; -> {"<frames a block>f <warps
    over the frames>x<warps over the bins>w": ms}."""
    import tpuasr_torch.ops.fbank as fbank_mod

    real, ms = fbank_mod._fbank_plan, {}
    try:
        for t in fbank_mod.FBANK_TILES:
            fbank_mod._fbank_plan = lambda *a, t=t: real(*a, tiles=t)
            ms["{}f {}x{}w".format(16 * t[0] * t[1], t[1], t[2])] = _time_ms(
                torch, lambda: fbank_mod.fbank_frames(*args.values()))
    finally:
        fbank_mod._fbank_plan = real
    print("  by block shape (frames, warps over them x over the bins), ms: "
          + "; ".join(f"{k}: {v:.4f}" for k, v in ms.items()))
    return ms


def _joint_fwd_plan_line(torch, enc, pred, w, tag) -> dict:
    """Print kernel #4's plan at these operands' shape (its tiles, blocks and
    the bytes of W's tiles its blocks ask of L2 a call, counted from the
    plan: no number here is measured); -> the plan's numbers."""
    from tpuasr_torch.ops.ffn import _sm_count
    from tpuasr_torch.ops.rnnt_fused import _joint_fwd_plan

    (b, t, d), u1, v = enc.shape, pred.shape[1], w.shape[1]
    plan = _joint_fwd_plan(b, t, u1, d, v, _sm_count(enc.device.index))
    print(f"rnnt_fused_fwd {tag} plan: tt {plan['tt']} x uc {plan['uc']}, grid {plan['grid']} "
          f"({plan['blocks']} blocks, {plan['waves']} waves), {plan['smem']} B shared a block, "
          f"W's tiles asked of L2 {plan['l2_w_bytes'] / 1e9:.3f} GB a call (blocks x W's "
          f"tile bytes, counted from the plan, not measured)")
    return {k: plan[k] for k in ("tt", "uc", "blocks", "waves", "smem", "l2_w_bytes")}


def _attention_train_checks(torch, dev, bench) -> dict:
    """Kernels #2 and #3 against their plain versions at the training shape
    (phase 6b's encoder: [12, 191, 256] bf16, its padding and a drawn
    dynamic chunk), at an fp32 ragged shape with a fully masked query row,
    with a [B, 1, S] padding mask, and at 6a's fp32 step (the encoder of
    [2, 256] feature frames, lengths 256 and 200, static chunk 32); ->
    {"attention_training", "attention_bwd"}: the records at the training
    shape, each with 6a's fp32 record under "fp32_step"."""
    import numpy as np

    from tpuasr_torch.nn.masks import chunk_mask, draw_dynamic_chunk, dynamic_chunk_size
    from tpuasr_torch.ops import relpos_attention_bwd
    from tpuasr_torch.ops.relpos_attention import _relpos_fwd

    out = {}
    h, dk = 4, 64
    d = h * dk
    t_bench = int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    lens = torch.as_tensor(_enc_len(bench["wave_lens"].cpu().numpy()))
    for seed in range(100):  # a draw that chunks (about half give full context)
        cs, left = dynamic_chunk_size(*draw_dynamic_chunk(torch.Generator().manual_seed(seed),
                                                          t_bench), t_bench, 25, False)
        if cs < t_bench:
            break
    pad = torch.arange(t_bench)[None, None, :] < lens[:, None, None]  # [B, 1, T]
    ragged = (torch.arange(37)[None, :] < torch.tensor([37, 20, 30])[:, None])[:, None, :]
    ragged = ragged & chunk_mask(37, 8, 2)[None]
    ragged[1, 5] = False  # a fully masked query row
    bcast = torch.ones(4, 1, 60, dtype=torch.bool)
    bcast[3, 0, 41:] = False
    t6a = int(_enc_len(np.array([255 * HOP]))[0])  # 256 feature frames
    lens6a = torch.tensor([t6a, int(_enc_len(np.array([199 * HOP]))[0])])
    step = (torch.arange(t6a)[None, None, :] < lens6a[:, None, None]) & chunk_mask(t6a, 32, -1)
    cases = (("training", torch.bfloat16, pad & chunk_mask(t_bench, cs, left)[None]),
             ("ragged", torch.float32, ragged), ("broadcast", torch.bfloat16, bcast),
             ("step_fp32", torch.float32, step))
    print(f"training-shape mask: the encoder's padding and a dynamic chunk of {cs} frames "
          f"(left chunks {left})")
    g = torch.Generator().manual_seed(SEED + 5)
    for tag, dtype, mask in cases:
        t0 = time.perf_counter()
        b, t = mask.shape[0], mask.shape[2]
        q, k, v, do = (torch.randn(b, t, d, generator=g).to(dev, dtype) for _ in range(4))
        p = torch.randn(1, t, d, generator=g).to(dev, dtype)
        u_, v_ = ((0.1 * torch.randn(d, generator=g)).to(dev, dtype) for _ in range(2))
        args = dict(q=q, k=k, p=p, v=v, u_bias=u_, v_bias=v_, mask=mask.to(dev),
                    scale=1.0 / math.sqrt(dk), n_head=h)
        rec = _hold(torch, "relpos_attention", dict(args, saved=True), tag)
        # #3 alone: the forward's saved fp32 output and log-sum-exp made
        # once, as the autograd Function hands them over
        saved = _relpos_fwd(*args.values(), saved=True)[1:]
        bwd_args = dict(list(args.items())[:7] + [("do", do)] + list(args.items())[7:],
                        out=saved[0], lse=saved[1])
        rec_b = _hold(torch, "relpos_attention_bwd", bwd_args, tag)
        if tag == "ragged":
            dq = relpos_attention_bwd(*bwd_args.values())[0]
            require(bool((dq[1, 5] == 0).all()), "a fully masked query row got a gradient")
        if tag == "step_fp32":  # the one profile: the fp32 route's two sides and its sum
            t1 = time.perf_counter()
            split = _device_split(torch, lambda: relpos_attention_bwd(*bwd_args.values()))
            print(f"#3 at the {tag} shape, device ms a call by kernel (profiler, "
                  f"{time.perf_counter() - t1:.1f} s): " + "; ".join(
                      f"{ms:.4f} {key[:60]}"
                      for key, ms in sorted(split.items(), key=lambda x: -x[1])))
            rec_b["device_split_ms"] = split
        if tag == "training":
            rec["vs_fp32"], rec_b["vs_fp32"] = _vs_fp32(torch, args, do, saved)
            out["attention_training"], out["attention_bwd"] = rec, rec_b
        if tag == "step_fp32":
            out["attention_training"]["fp32_step"], out["attention_bwd"]["fp32_step"] = rec, rec_b
        print(f"(attention case {tag}: {time.perf_counter() - t0:.1f} s)")
    return out


def _vs_fp32(torch, a, do, saved) -> tuple[dict, dict]:
    """The bf16 kernels #2/#3 and the plain bf16 versions, each against the
    fp32 plain version on the same bf16 values: -> ({"kernel",
    "kernel_saved", "plain"}: the error over the output's max; #2 without
    and with its saved fp32 output, and "differ": the outputs on which those
    two differ) for the forward, and per output for the backward."""
    from tpuasr_torch.ops.relpos_attention import (
        _relpos_fwd, relpos_attention_bwd, relpos_attention_bwd_plain, relpos_attention_plain,
    )

    up = lambda v: v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v
    f32 = [up(v) for v in a.values()]
    bf = list(a.values())
    rel = lambda x, r: float((x.float() - r).abs().max() / r.abs().max().clamp(min=1e-30))
    ref = relpos_attention_plain(*f32)
    alone, saving = _relpos_fwd(*bf), _relpos_fwd(*bf, saved=True)[0]
    fwd = {"kernel": rel(alone, ref), "kernel_saved": rel(saving, ref),
           "plain": rel(relpos_attention_plain(*bf), ref),
           "differ": int((alone != saving).sum())}
    sc, h = a["scale"], a["n_head"]
    names = ("dq", "dk", "dv", "dp", "du", "dvb")
    refs = relpos_attention_bwd_plain(*f32[:7], do.float(), sc, h)
    kern = relpos_attention_bwd(*bf[:7], do, sc, h, *saved)
    plain = relpos_attention_bwd_plain(*bf[:7], do, sc, h)
    bwd = {n: {"kernel": rel(x, r), "plain": rel(y, r)}
           for n, x, y, r in zip(names, kern, plain, refs)}
    print(f"bf16 against the fp32 plain version on the same bf16 values (error / the "
          f"output's max): #2 kernel {fwd['kernel']:.3g} (saving for the backward "
          f"{fwd['kernel_saved']:.3g}; {fwd['differ']} of {saving.numel()} outputs differ "
          f"between the two), plain bf16 {fwd['plain']:.3g}; #3 "
          + ", ".join(f"{n} kernel {v['kernel']:.3g} plain {v['plain']:.3g}"
                      for n, v in bwd.items()))
    return fwd, bwd


def _device_split(torch, fn, iters: int = 10) -> dict:
    """torch.profiler's device ms a call of fn, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _ffn_checks(torch, dev) -> dict:
    """Kernels #10/#11 against their plain versions at the shapes the paths
    give them: the training steps of phase 6d (12 x 191 rows, bf16,
    keep-masks at rate 0.1, ff_scale 0.5), offline serving (4 x 187 rows, fp32,
    no masks) and a streaming chunk (4 streams x 32 frames, fp32), and #10 at
    the serving and streaming shapes in bf16 (bf16 serving with
    `fused_ffn=True` takes the tensor-core route); at the training shape two
    calls of each must give the same bits, each call's device time is split
    by kernel, and both are timed at other counts of H slices than the
    plan's; -> the records {"ffn_fwd", "ffn_bwd"} at the training shape,
    {"ffn_fwd_serving"} at the serving shape (fp32) and
    {"ffn_fwd_serving_bf16", "ffn_fwd_streaming_bf16"}."""
    import numpy as np

    from tpuasr_torch.ops import ffn_bwd, ffn_fwd

    out = {}
    d, h, rate, scale = 256, 1024, 0.1, 0.5
    rows = BENCH_B * int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    g = torch.Generator().manual_seed(SEED + 17)
    rn = lambda *shape: torch.randn(*shape, generator=g)
    for tag, r, dtype, masks in (("training", rows, torch.bfloat16, True),
                                 ("serving", 4 * 187, torch.float32, False),
                                 ("streaming", 4 * CHUNK, torch.float32, False),
                                 ("serving_bf16", 4 * 187, torch.bfloat16, False),
                                 ("streaming_bf16", 4 * CHUNK, torch.bfloat16, False)):
        args = dict(x=rn(r, d).to(dev, dtype), ln_scale=(1.0 + 0.1 * rn(d)).to(dev),
                    ln_bias=(0.1 * rn(d)).to(dev), w1=(rn(h, d) / d ** 0.5).to(dev, dtype),
                    b1=(0.1 * rn(h)).to(dev), w2=(rn(d, h) / h ** 0.5).to(dev, dtype),
                    b2=(0.1 * rn(d)).to(dev), mask1=None, mask2=None)
        if masks:
            args["mask1"] = (torch.rand(r, h, generator=g) >= rate).to(torch.uint8).to(dev)
            args["mask2"] = (torch.rand(r, d, generator=g) >= rate).to(torch.uint8).to(dev)
        do = rn(r, d).to(dev, dtype)
        fwd_args = dict(args, rate=rate, ff_scale=scale)
        bwd_args = dict(args, dout=do, rate=rate, ff_scale=scale)
        rec = _hold(torch, "ffn_fwd", fwd_args, tag)
        if tag.endswith("bf16"):
            out[f"ffn_fwd_{tag}"] = rec
            continue
        rec_b = _hold(torch, "ffn_bwd", bwd_args, tag)
        if tag == "serving":
            out["ffn_fwd_serving"] = rec
        if tag != "training":
            continue
        for name, fn, a in (("ffn_fwd", ffn_fwd, fwd_args), ("ffn_bwd", ffn_bwd, bwd_args)):
            first, again = fn(*a.values()), fn(*a.values())
            torch.cuda.synchronize()
            first, again = ((x,) if isinstance(x, torch.Tensor) else x for x in (first, again))
            require(all(torch.equal(x, y) for x, y in zip(first, again)),
                    f"two calls of {name} on the same inputs differ")
            split = _device_split(torch, lambda: fn(*a.values()))
            print(f"{name} at the training shape: two calls bit-identical; device ms a call "
                  f"by kernel (profiler): " + "; ".join(
                      f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(),
                                                                   key=lambda x: -x[1])))
            (rec if name == "ffn_fwd" else rec_b)["device_split_ms"] = split
        rec["slices_ms"], rec_b["slices_ms"] = _ffn_slices(torch, r, fwd_args, bwd_args)
        out["ffn_fwd"], out["ffn_bwd"] = rec, rec_b
    return out


def _ffn_slices(torch, r, fwd_args, bwd_args) -> tuple[dict, dict]:
    """#10 and #11 at the training shape timed with the hidden dimension
    split into other counts of slices than the plan's; -> ({slices: ms}
    forward, {slices: ms} backward)."""
    from tpuasr_torch.ops import ffn as ffn_mod

    x, h = fwd_args["x"], fwd_args["w1"].shape[0]
    d, n_chunks = x.shape[1], h // ffn_mod.KERNEL_H_MULTIPLE
    plan = ffn_mod._ffn_plan(r, d, h, x.dtype, ffn_mod._sm_count(x.device.index))
    real = ffn_mod._ffn_plan
    fwd, bwd = {}, {}
    try:
        for want in (1, 2, 3, 4, 7, 8, 11, 16):
            s = ffn_mod._slices(n_chunks, 1, want, 1)
            ffn_mod._ffn_plan = lambda r_, d_, h_, dt, n_sm, s=s: ffn_mod._plan_for(
                r_, d_, h_, dt, s, s)
            fwd[s] = _time_ms(torch, lambda: ffn_mod.ffn_fwd(*fwd_args.values()))
            bwd[s] = _time_ms(torch, lambda: ffn_mod.ffn_bwd(*bwd_args.values()))
    finally:
        ffn_mod._ffn_plan = real
    print(f"#10 / #11 at the training shape by H slices ({plan['tiles']} row tiles; the "
          f"plan's {plan['fwd_slices']} / {plan['bwd_slices']}), ms: "
          + "; ".join(f"{s}: {fwd[s]:.4f} / {bwd[s]:.4f}" for s in fwd))
    return fwd, bwd


def _record(torch, name, source, replaces, err, flops, peak, nbytes, kernel, plain,
            library, plain_iters: int = 30, plain_timing: str = "events",
            timed: bool = True) -> dict:
    """One kernel's record for the kernels line. The kernel is always timed
    by events; `plain_timing` says how its plain version and the library
    call are timed, and `timing` records it beside the numbers. Untimed
    (`timed` False), the three times are None."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    clock = (lambda fn, *a, **k: _time_ms(torch, fn, *a, **k)) if timed else (lambda *a, **k: None)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": err, "ms": clock(kernel),
        "plain_ms": clock(plain, plain_iters, method=plain_timing),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None if library is None else clock(library, method=plain_timing),
        "timing": {"ms": "events", "plain_ms": plain_timing,
                   "library_ms": None if library is None else plain_timing},
    }


# kernel -> (module, the wrapper that launches it, its plain version, the
# kernel's source, the TPU kernel it replaces)
WRAPPERS = {
    "fbank": ("tpuasr_torch.ops.fbank", "fbank_frames", "fbank_frames_plain",
              "tpuasr_torch/csrc/fbank.cu", "tpuasr/ops/fbank_pallas.py:25"),
    "relpos_attention": ("tpuasr_torch.ops.relpos_attention", "_relpos_fwd",
                         "relpos_attention_plain", "tpuasr_torch/csrc/relpos_attention.cu",
                         "tpuasr/ops/attention_pallas.py:72"),
    "relpos_attention_bwd": ("tpuasr_torch.ops.relpos_attention", "relpos_attention_bwd",
                             "relpos_attention_bwd_plain",
                             "tpuasr_torch/csrc/relpos_attention.cu",
                             "tpuasr/ops/attention_pallas.py:87"),
    "rnnt_fused_fwd": ("tpuasr_torch.ops.rnnt_fused", "rnnt_fused_lp", "rnnt_fused_lp_plain",
                       "tpuasr_torch/csrc/rnnt_fused.cu", "tpuasr/ops/rnnt_fused_pallas.py:38"),
    "rnnt_fused_bwd": ("tpuasr_torch.ops.rnnt_fused", "rnnt_fused_grads",
                       "rnnt_fused_grads_plain", "tpuasr_torch/csrc/rnnt_fused.cu",
                       "tpuasr/ops/rnnt_fused_pallas.py:71"),
    "ctc_alpha": ("tpuasr_torch.ops.ctc", "ctc_alpha", "ctc_alpha_plain",
                  "tpuasr_torch/csrc/ctc_lattice.cu", "tpuasr/ops/ctc_pallas.py:56"),
    "ctc_beta_grad": ("tpuasr_torch.ops.ctc", "ctc_beta_grad", "ctc_beta_grad_plain",
                      "tpuasr_torch/csrc/ctc_lattice.cu", "tpuasr/ops/ctc_pallas.py:83"),
    "rnnt_alpha": ("tpuasr_torch.ops.rnnt_lattice", "rnnt_alpha", "rnnt_alpha_plain",
                   "tpuasr_torch/csrc/rnnt_lattice.cu", "tpuasr/ops/rnnt_pallas.py:88"),
    "rnnt_beta_grad": ("tpuasr_torch.ops.rnnt_lattice", "rnnt_beta_grad",
                       "rnnt_beta_grad_plain", "tpuasr_torch/csrc/rnnt_lattice.cu",
                       "tpuasr/ops/rnnt_pallas.py:111"),
    "ffn_fwd": ("tpuasr_torch.ops.ffn", "ffn_fwd", "ffn_fwd_plain", "tpuasr_torch/csrc/ffn.cu",
                "tpuasr/ops/ffn_pallas.py:169"),
    "ffn_bwd": ("tpuasr_torch.ops.ffn", "ffn_bwd", "ffn_bwd_plain", "tpuasr_torch/csrc/ffn.cu",
                "tpuasr/ops/ffn_pallas.py:190"),
}


def _hold(torch, name, args, tag, ctc_inputs=None, timed: bool = True) -> dict:
    """Kernel `name` against its plain version on `args` (`_held`): print
    the result under `tag` and fail outside the tolerance; -> the record,
    with the inputs' shapes and the tolerance (untimed: no times)."""
    rec, tol, ok, inputs = _held(torch, name, args, ctc_inputs or {}, timed)
    ms = lambda x: "-" if x is None else f"{x:.4f}"
    print(f"{name} {tag} {inputs}: max_abs_err {rec['max_abs_err']:.3g} (tol {tol}) ms "
          f"{ms(rec['ms'])} plain_ms ({rec['timing']['plain_ms']}) {ms(rec['plain_ms'])} "
          f"library_ms {rec['library_ms']} bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']})")
    require(ok, f"{name} disagrees with its plain version ({tag}: {inputs})")
    return dict(rec, inputs=inputs, tol=tol)


def _held(torch, name, a, ctc_inputs, timed: bool = True) -> tuple[dict, str, bool, str]:
    """Kernel `name` against its plain version on the arguments `a`
    (argument name -> value, in the wrapper's order), with the kernel's
    tolerance and why, its bound (the function's least work and bytes on
    these inputs) and the PyTorch call that computes the same function where
    there is one; -> (record, tolerance, within it, the inputs' shapes).
    `ctc_inputs` ({key: [calls, lattice_inputs' arguments]}) holds the CTC
    log-probs and labels behind a CTC kernel's inputs, for F.ctc_loss."""
    import importlib

    import torch.nn.functional as F

    modname, wrapper, plain_name, source, replaces = WRAPPERS[name]
    mod = importlib.import_module(modname)
    kernel, plain = getattr(mod, wrapper), getattr(mod, plain_name)
    args = tuple(a.values())
    got = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    got, ref = ((x,) if isinstance(x, torch.Tensor) else tuple(x) for x in (got, ref))
    # the fp32 attention backward sums in a fixed order: a second call gives its bits
    same = name != "relpos_attention_bwd" or a["q"].dtype != torch.float32 or all(
        torch.equal(x, y) for x, y in zip(got, kernel(*args)))
    stats_err = None
    if name == "relpos_attention" and len(got) == 3:  # saved=True: (out, out32, lse)
        stats_err = _stats_err(torch, got[1:], ref[1:])
        got, ref = got[:1], ref[:1]
    diffs = [(x.float() - y.float()).abs() for x, y in zip(got, ref)]
    err = max(float(d.max()) for d in diffs)
    rels = [float(d.max()) / max(float(y.float().abs().max()), 1e-30) for d, y in zip(diffs, ref)]
    inputs = ", ".join(f"{k} {str(v.dtype)[6:]}{list(v.shape)}" for k, v in a.items()
                       if isinstance(v, torch.Tensor) and v.dim() >= 2)
    inputs += "".join(f", {k} None" for k, v in a.items() if v is None)
    library, plain_iters, timing, bound_fp32, backend = None, 30, "events", None, None

    if name == "fbank":
        rows, n_fft = a["frames"].shape
        n_freq, n_mels = a["mel"].shape
        # a bin far below its frame's loudest bin is a sum of 1024 terms that
        # cancel, so fp32 sums in another order move it by up to ~1e-2 dB;
        # with bf16 operands a power bin may also round to the neighbouring
        # bf16 value, 10*log10(1 + 2**-7) = 0.034 dB
        tol = 2e-2 if a["precision"] == "highest" else 5e-2
        ok = err <= tol
        why = f"{tol} dB: fp32 sums in another order, cancelling bins" + (
            "" if a["precision"] == "highest" else ", and one bf16 ulp of a power bin")
        # the least work: a real FFT per frame (2.5 n log2 n), the window,
        # |X|^2, the mel product over the filters' nonzeros, max and log;
        # bytes: the frames, window and mel matrix in, the log-mel out
        flops = rows * (2.5 * n_fft * math.log2(n_fft) + n_fft + 3 * n_freq
                        + 2 * int((a["mel"] != 0).sum()) + 2 * n_mels)
        peak, nbytes = PEAK_FP32, 4 * (rows * n_fft + n_fft + n_freq * n_mels + rows * n_mels)
    elif name in ("relpos_attention", "relpos_attention_bwd"):
        q, k, p, v, mask, h = a["q"], a["k"], a["p"], a["v"], a["mask"], a["n_head"]
        b, t, d = q.shape
        s, dk, es = k.shape[1], d // h, q.element_size()
        fp32 = q.dtype == torch.float32
        pairs = int(mask.expand(b, t, s).sum())  # unmasked (query, key) pairs per head
        # fp32 runs 3xTF32 products: the bound at that floor (three TF32
        # passes a product), the fp32 CUDA-core figure beside it
        peak = PEAK_TF32 if fp32 else PEAK_BF16
        # library yardstick: SDPA on [q+u | q+v], [k | p], v
        heads = lambda x: x.view(x.shape[0], -1, h, dk).transpose(1, 2)
        sq = torch.cat([heads(q + a["u_bias"]), heads(q + a["v_bias"])], dim=-1)
        sk = torch.cat([heads(k), heads(p).expand(b, -1, -1, -1)], dim=-1)
        sdpa = dict(attn_mask=mask[:, None], scale=a["scale"])
        backend = _sdpa_backend(torch, sq, sk, heads(v), **sdpa)
        if name == "relpos_attention":
            tol = 1e-5 if fp32 else 1e-2
            ok = all(bool((dd <= tol + tol * y.float().abs()).all()) for dd, y in zip(diffs, ref))
            why = f"{tol} + {tol}*|ref|: " + (
                "3xTF32 products (about 21 bits) and fp32 sums in another order" if fp32 else
                "bf16 roundings of the output and the probabilities at other points, 2**-8 each")
            flops = pairs * h * 6 * dk  # scores 4 dk, a.v 2 dk per pair
            nbytes = es * (2 * b * t * d + 2 * b * s * d + s * d + 2 * d) + mask.numel()
            if stats_err is not None:  # the fp32 output and each row's log-sum-exp out
                ok = ok and stats_err[1]
                why += (f"; saved fp32 output and lse max_abs_err {stats_err[0]:.3g} (tol 1e-4 + "
                        f"1e-5*|ref|, a fully masked row's lse -inf on both sides: fp32 sums "
                        f"in another order, " + ("3xTF32 products)" if fp32 else
                                                 "bf16 p in two bf16 parts, 16 bits)"))
                # each row's lse out, and bf16's fp32 output beside its bf16 one
                nbytes += 4 * (b * h * t + (0 if fp32 else b * t * d))
                timing = "profiler"  # 30 plain calls with the logsumexp outlast the sleep
            library = lambda: F.scaled_dot_product_attention(sq, sk, heads(v), **sdpa)
        else:
            tol = 1e-4 if fp32 else 2.0 ** -6
            ok = max(rels) <= tol
            why = f"{tol:.3g} of each output's max|ref|: " + (
                "3xTF32 products (about 21 bits) and fp32 sums in another order, the same "
                "order in every run (two calls bit-identical: "
                f"{'yes' if same else 'NO'})" if fp32 else
                "ds rounds to bf16 before the products, a value on a rounding edge may round "
                "the other way, and the outputs round to bf16")
            # scores 4 dk, da, dv and dq 2 dk each, dk|dp 4 dk; bytes: q, k, v,
            # p, do, the biases, the mask and the forward's saved fp32 output and
            # log-sum-exp in, dq, dk, dv, fp32 dp, du, dvb out
            flops = pairs * h * 14 * dk
            nbytes = (es * (3 * b * t * d + 4 * b * s * d + s * d + 2 * d)
                      + 4 * (b * t * d + s * d + 2 * d + b * h * t) + mask.numel())
            lib_in = [x.detach().requires_grad_() for x in (sq, sk, heads(v))]
            lib_out = F.scaled_dot_product_attention(*lib_in, **sdpa)
            lib_g = heads(a["do"])
            library = lambda: torch.autograd.grad(lib_out, lib_in, lib_g, retain_graph=True)
            plain_iters, timing = 10, "profiler"
            ok = ok and same
        if fp32:
            bound_fp32 = max(flops / PEAK_FP32, nbytes / HBM_BPS) * 1e3
            flops *= 3
            why += f"; bound at the fp32 CUDA-core peak {bound_fp32:.6f} ms"
        why += f"; SDPA backend {backend}"
    elif name in ("rnnt_fused_fwd", "rnnt_fused_bwd"):
        enc, pred, w = a["enc_p"], a["pred_p"], a["w"]
        b, t, d = enc.shape
        u1, v = pred.shape[1], w.shape[1]
        rows = b * t * u1
        io = b * t * d + b * u1 * d + d * v + v
        # the bound at the card's own floor for fp32 products: 3xTF32 (three
        # TF32 passes a product); the fp32 CUDA-core figure beside it
        if name == "rnnt_fused_fwd":
            tol = 5e-4
            ok = err <= tol
            why = (f"{tol}: 3xTF32 products (about 21 bits) and fp32 sums of {d} in another "
                   f"order on logits up to ~10, ~1e-5 expected; the online logsumexp (ex2.approx "
                   f"terms) against torch's; the same bits in every run")
            work, nbytes = 2.0 * rows * d * v, 4 * (io + b * (u1 - 1) + 3 * rows)
        else:
            tol = 1e-4
            ok = max(rels) <= tol
            why = (f"{tol} of each output's max|ref|: 3xTF32 products (about 21 bits) and "
                   f"fp32 sums in another order, the same order in every run")
            work, nbytes = 6.0 * rows * d * v, 4 * (2 * io + b * (u1 - 1) + 3 * rows)
        flops, peak = 3 * work, PEAK_TF32
        bound_fp32 = max(work / PEAK_FP32, nbytes / HBM_BPS) * 1e3
        why += f"; bound at the fp32 CUDA-core peak {bound_fp32:.4f} ms"
    elif name in ("rnnt_alpha", "ctc_alpha"):
        (ga, gll), (ra, rll) = got, ref
        live = ra > -1e29
        ok = torch.equal(live, ga > -1e29) and torch.equal(rll > -1e29, gll > -1e29)
        err = max(float((ga - ra)[live].abs().max()), float((gll - rll).abs().max()))
        ok = ok and bool(((ga - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
        ok = ok and bool(((gll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
        why = ("1e-3 + 1e-5*|ref| over reachable cells, which must match: fp32 log-adds "
               "whose exp/log1p may differ from torch's by an ulp (the warp routes: ex2/lg2 "
               "log-adds that round at other points, CTC's three-term one once where plain "
               "rounds twice), over every dependent step")
        peak, plain_iters, timing = PEAK_FP32, 5, "profiler"
        if name == "rnnt_alpha":
            b, t, u1 = a["blank_lp"].shape
            flops, nbytes = 10.0 * b * t * u1, 4 * (2 * b * t * u1 + b * t * (u1 - 1) + 2 * b)
        else:
            b, t, s = a["lp_states"].shape
            active = int(torch.clamp(a["tlens"], 0, t).sum()) * s
            flops, nbytes = 13.0 * active, 4 * (2 * b * t * s + 2 * b) + 2 * b * s
            library = _ctc_library(torch, a, ctc_inputs, backward=False)
    elif name in ("rnnt_beta_grad", "ctc_beta_grad"):
        ok = all(bool((dd <= 2e-3 * y.abs() + 1e-5).all()) for dd, y in zip(diffs, ref))
        why = "2e-3*|ref| + 1e-5: exp of a log-domain sum carrying alpha's error"
        peak, plain_iters, timing = PEAK_FP32, 5, "profiler"
        if name == "rnnt_beta_grad":
            b, t, u1 = a["blank_lp"].shape
            cells = b * t * u1
            # blank and alpha in, gblank out; label in, glabel out; u_lens, ll, g
            flops, nbytes = 20.0 * cells, 4 * (3 * cells + 2 * b * t * (u1 - 1) + 3 * b)
        else:
            b, t, s = a["lp_states"].shape
            active = int(torch.clamp(a["tlens"], 0, t).sum()) * s
            flops, nbytes = 19.0 * active, 4 * (3 * b * t * s + 3 * b) + 2 * b * s
            library = _ctc_library(torch, a, ctc_inputs, backward=True)
    else:  # ffn_fwd, ffn_bwd
        x, h = a["x"], a["w1"].shape[0]
        r, d = x.shape
        fp32 = x.dtype == torch.float32
        es, peak = x.element_size(), PEAK_FP32 if fp32 else PEAK_BF16
        masks = 0 if a["mask1"] is None else r * (h + d)
        timing = "profiler"  # a plain FFN enqueues too many launches for the sleep
        if name == "ffn_fwd":
            tol = 1e-5 if fp32 else 2.0 ** -7
            why = "fp32 sums in another order" if fp32 else (
                "the same bf16 rounding points, but a sum in another order can cross a bf16 "
                "rounding edge (one ulp is 2**-8 relative)")
            # x, out, both weights, LN scale/bias and biases, the masks
            flops = 4.0 * r * d * h
            nbytes = es * (2 * r * d + 2 * d * h) + 4 * (3 * d + h) + masks
        else:
            tol = 1e-4 if fp32 else 2.0 ** -6
            why = ("fp32 sums in another order (the same order in every run)" if fp32 else
                   "dy, the activation and dh round to bf16 before the products, a value on "
                   "a rounding edge may round the other way; dx rounds to bf16")
            # five products; x, do, the weights and masks in, dx and the fp32
            # weight and vector gradients out
            flops = 10.0 * r * d * h
            nbytes = (es * (3 * r * d + 2 * d * h) + 4 * (2 * d + h) + masks
                      + 4 * (2 * d * h + 3 * d + h))
        ok = max(rels) <= tol
        why = f"{tol:.3g} of each output's max|ref|: {why}"
    if not ok and len(rels) > 1:
        why += f"; error / max|ref| per output: {', '.join(f'{r:.3g}' for r in rels)}"
    rec = _record(torch, name, source, replaces, err, flops, peak, nbytes,
                  lambda: kernel(*args), lambda: plain(*args), library, plain_iters, timing,
                  timed)
    if stats_err is not None:
        rec["saved_max_abs_err"] = stats_err[0]
    if bound_fp32 is not None:
        rec["bound_fp32_ms"] = bound_fp32
    if backend is not None:
        rec["library_backend"] = backend
    return rec, why, bool(ok), inputs


def _sdpa_backend(torch, *args, **kwargs) -> str:
    """The backend `scaled_dot_product_attention` picks for these inputs
    (torch's own dispatch choice), by name."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name


def _stats_err(torch, got, ref) -> tuple[float, bool]:
    """What the forward saves for the backward (the fp32 output and each
    row's log-sum-exp) against the plain version's: -> (max abs error, every
    entry within 1e-4 + 1e-5*|ref| and a fully masked row's lse -inf on both
    sides)."""
    err, ok = 0.0, True
    for x, r in zip(got, ref):
        live = torch.isfinite(r)
        ok = ok and torch.equal(live, torch.isfinite(x)) and bool((x[~live] == -torch.inf).all())
        d = (x - r).abs()[live]
        if d.numel():
            err = max(err, float(d.max()))
            ok = ok and bool((d <= 1e-4 + 1e-5 * r[live].abs()).all())
    return err, ok


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol in a
    source's anonymous namespace (`_ZN<n><namespace><n>relpos_fwd_kernelIfLi64EEEv...`
    -> `relpos_fwd_kernel<float, 64>`), else the symbol."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    n = m and re.match(r"\d+", mangled[m.end(1) + int(m.group(1)):])
    if not n:
        return mangled
    start = m.end(1) + int(m.group(1)) + n.end()
    name, rest = mangled[start:start + int(n.group())], mangled[start + int(n.group()):]
    if not rest.startswith("I"):
        return name
    args, tok = [], re.compile(r"f|13__nv_bfloat16|L[ib]\d+E")  # the sources' kinds
    pos = 1
    while (t := tok.match(rest, pos)) is not None:
        args.append({"f": "float", "13__nv_bfloat16": "bf16"}.get(t.group(), t.group()[2:-1]))
        pos = t.end()
    return f"{name}<{', '.join(args)}>"


def _ctc_library(torch, a, ctc_inputs, backward: bool):
    """F.ctc_loss (forward, or its backward on a retained graph) on the
    log-probs and labels whose lattice inputs are the CTC kernel's `a`, or
    None when `ctc_inputs` holds none."""
    import torch.nn.functional as F

    b, t, s = a["lp_states"].shape
    match = [x for _, x in ctc_inputs.values()
             if tuple(x["log_probs"].shape[:2]) == (b, t) and 2 * x["labels"].shape[1] + 1 == s]
    if not match:
        return None
    x = match[0]
    lp = x["log_probs"].detach().transpose(0, 1)
    # a batch's padding rows have no frames (encoder length -1 clamps to 0)
    lens = (x["labels"].long(), tuple(max(int(n), 0) for n in a["tlens"]),
            tuple(int(n) for n in x["label_lens"]))
    kw = dict(blank=x["blank"], reduction="sum", zero_infinity=True)
    if not backward:
        return lambda: F.ctc_loss(lp, *lens, **kw)
    lp = lp.requires_grad_()
    loss = F.ctc_loss(lp, *lens, **kw)
    return lambda: torch.autograd.grad(loss, lp, retain_graph=True)


def _flagship(dtype: str, fused_ffn: bool = False):
    """The reference flagship (__graft_entry__._flagship_config on an
    accelerator): causal dynamic-chunk conformer, static chunk 32, the
    rel-pos attention kernel on the full-context path; with `fused_ffn` the
    FFNs through kernel #10."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    enc = cfg.model.encoder
    enc.causal, enc.use_dynamic_chunk, enc.static_chunk_size = True, True, 32
    enc.fused_attention, enc.fused_ffn = True, fused_ffn
    return cfg


def _model(torch, cfg, device, blank_bias: float = 0.0, ctc_blank_bias: float = 0.0):
    from tpuasr_torch.models import Transducer, init_weights

    model = init_weights(Transducer(cfg.model, device=device), SEED)
    with torch.no_grad():
        model.joint.ffn_out_bias[cfg.model.blank_id] = blank_bias
        model.ctc.ctc_lo.bias[cfg.model.blank_id] = ctc_blank_bias
    return model


def _fit_blank_bias(torch, model, cfg, waves, wave_lens, text_lens) -> float:
    """Set the blank logit (bisection on [0, 16]; a HAT joint's blank bias on
    [-16, 16]) so that greedy search on
    the requests emits as many tokens per encoder frame as their
    transcripts hold; -> the bias. A random model otherwise emits up to
    n_steps tokens per frame, and the greedy loop's cost scales with that."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_greedy_decode

    feats, flens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
    enc, elens = model.encode(feats, flens)
    target = float(text_lens.sum()) / float(elens.sum())
    blank = cfg.model.blank_id
    # the plain head's blank logit; a HAT joint's blank head's bias (on [-16,
    # 16]: its log-sigmoid already gives the blank about half the mass)
    bias, at, lo = ((model.joint.blank_pred.bias, 0, -16.0) if cfg.model.joint.hat_joint
                    else (model.joint.ffn_out_bias, blank, 0.0))

    def rate(b: float) -> float:
        with torch.no_grad():
            bias[at] = b
        _, lens = rnnt_greedy_decode(model, enc, elens, blank)
        return float(lens.sum()) / float(elens.sum())

    free = rate(0.0)
    hi = 16.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if rate(mid) > target else (lo, mid)
    got = rate(hi)
    print(f"blank logit bias {hi:.4f}: {got:.4f} tokens per encoder frame, target "
          f"{target:.4f} from the transcripts ({int(text_lens.sum())} tokens over "
          f"{int(elens.sum())} frames); {free:.4f} with no bias")
    return hi


def _serve(torch, dev, data) -> tuple[dict, dict]:
    """Phases 4-5; -> (the serving records, the models with the fitted blank
    logit: fp32 on the card and the CPU, fp32 with the fused FFN, bf16 on
    the card, their configs and the bias)."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_greedy_decode, streaming_greedy_decode
    from tpuasr_torch.eval import make_offline_decoder, measure_rtf
    from tpuasr_torch.streaming import num_chunks

    print("== phase 4: offline serving (make_offline_decoder rnnt_greedy)")
    cfg32 = _flagship("float32")
    waves, wave_lens = data["fixture"]
    gpu32 = _model(torch, cfg32, dev)
    bias = _fit_blank_bias(torch, gpu32, cfg32, waves, wave_lens, data["text_lens"])
    cpu32 = _model(torch, cfg32, "cpu", bias)
    dec_gpu = make_offline_decoder(gpu32, cfg32, "rnnt_greedy")
    toks_g, lens_g = dec_gpu(waves, wave_lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_g, lens_g = dec_gpu(waves, wave_lens)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    toks_c, lens_c = make_offline_decoder(cpu32, cfg32, "rnnt_greedy")(waves, wave_lens)

    feats_g, flen_g = fbank_batch(waves, wave_lens, cfg32.feature, device=dev)
    feats_c, flen_c = fbank_batch(waves, wave_lens, cfg32.feature, device="cpu")
    feat_err = float((feats_g.cpu() - feats_c).abs().max())
    enc_g, _ = gpu32.encode(feats_g, flen_g)
    enc_c, _ = cpu32.encode(feats_c, flen_c)
    enc_err = float((enc_g.cpu() - enc_c).abs().max())
    same = torch.equal(toks_g.cpu(), toks_c) and torch.equal(lens_g.cpu(), lens_c)
    print(f"fp32 card vs CPU on {len(wave_lens)} requests: feature max_abs_err "
          f"{feat_err:.3g} dB (tol 2e-2: fp32 DFT sums in another order, cancelling "
          f"bins), encoder "
          f"max_abs_err {enc_err:.3g} (tol 2e-3: fp32 sums in another order through 12 "
          f"blocks, unit-scale output), tokens identical: {same} "
          f"(emitted {int(lens_g.sum())}); card latency {ms32:.1f} ms")
    require(feat_err <= 2e-2 and enc_err <= 2e-3, "card and CPU encoder outputs differ")
    require(same, "fp32 tokens on the card differ from the CPU run")
    stages = _offline_stages(torch, gpu32, cfg32, waves, wave_lens, ms32)

    # the same weights with the FFNs through kernel #10
    cfg32f = _flagship("float32", fused_ffn=True)
    gpu32f = _model(torch, cfg32f, dev, bias)
    require(all(torch.equal(a, b) for a, b in zip(gpu32.state_dict().values(),
                                                  gpu32f.state_dict().values())),
            "the fused-FFN model's weights differ")
    dec_f = make_offline_decoder(gpu32f, cfg32f, "rnnt_greedy")
    dec_f(waves, wave_lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_f, lens_f = dec_f(waves, wave_lens)
    torch.cuda.synchronize()
    ms32f = (time.perf_counter() - t0) * 1e3
    enc_f, _ = gpu32f.encode(feats_g, flen_g)
    enc_ferr = float((enc_f - enc_g).abs().max())
    same_f = torch.equal(toks_f, toks_g) and torch.equal(lens_f, lens_g)
    print(f"fp32 fused_ffn=True vs False on the card, {len(wave_lens)} requests: encoder "
          f"max_abs_err {enc_ferr:.3g} (tol 2e-3, as card vs CPU), tokens identical: {same_f}; "
          f"latency {ms32f:.1f} ms (fused_ffn=False {ms32:.1f} ms)")
    require(enc_ferr <= 2e-3, "the fused-FFN encoder output differs")
    require(same_f, "fp32 tokens with fused_ffn=True differ from fused_ffn=False")

    cfg16 = _flagship("bfloat16")
    gpu16, cpu16 = _model(torch, cfg16, dev, bias), _model(torch, cfg16, "cpu", bias)
    # the same fp32 features into both bf16 encoders: the check is the
    # encoder's, and the noise it is held to is bf16's own (bf16 vs fp32)
    enc16_g, _ = gpu16.encode(feats_c.to(dev), flen_c.to(dev))
    enc16_c, _ = cpu16.encode(feats_c, flen_c)
    d_card = (enc16_g.float().cpu() - enc16_c.float()).abs()
    d_noise = (enc16_c.float() - enc_c).abs()
    print(f"bf16 encoder, card vs CPU on {len(wave_lens)} requests: max_abs_err "
          f"{float(d_card.max()):.4g}, mean {float(d_card.mean()):.4g}; bf16's own noise "
          f"(CPU bf16 vs CPU fp32): max {float(d_noise.max()):.4g}, mean "
          f"{float(d_noise.mean()):.4g} (tol: 2x that noise; the two runs round partly at "
          f"other points, e.g. the attention kernel rounds unnormalised probabilities and "
          f"the plain version normalised ones, so their difference is itself bf16 noise)")
    require(enc16_g.dtype == torch.bfloat16 and enc16_c.dtype == torch.bfloat16,
            "the bf16 encoders did not compute in bf16")
    require(float(d_card.max()) <= 2 * float(d_noise.max())
            and float(d_card.mean()) <= 2 * float(d_noise.mean()),
            "the card's bf16 encoder output differs from the CPU's by more than bf16 noise")
    dec16 = make_offline_decoder(gpu16, cfg16, "rnnt_greedy")
    serving = {"offline_fp32_ms_16req": ms32, "offline_fp32_stages": stages,
               "offline_fp32_fused_ffn_ms_16req": ms32f,
               "fused_ffn_encoder_max_abs_err": enc_ferr,
               "blank_logit_bias": bias, "bf16_card_vs_cpu_encoder_max_abs_err":
               float(d_card.max()), "bf16_vs_fp32_encoder_max_abs_err": float(d_noise.max())}
    for src in ("fixture", "synthetic"):
        w, wl = data[src]
        dec16(w, wl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t16, l16 = dec16(w, wl)
        torch.cuda.synchronize()
        ms16 = (time.perf_counter() - t0) * 1e3
        ref_t, ref_l = (toks_g, lens_g) if src == "fixture" else \
            make_offline_decoder(gpu32, cfg32, "rnnt_greedy")(w, wl)
        n = torch.maximum(l16, ref_l)
        pos = torch.arange(t16.shape[1], device=dev)[None] < n[:, None]
        agree = float(((t16 == ref_t) & pos).sum() / pos.sum().clamp(min=1))
        print(f"bf16 offline on {src} ({len(wl)} requests, "
              f"{float(wl.max()) / 48000:.2f} s longest): latency {ms16:.1f} ms, "
              f"token agreement with fp32 {agree:.3f}")
        serving[f"offline_bf16_ms_{src}"] = ms16
        serving[f"bf16_fp32_token_agreement_{src}"] = agree

    print(f"== phase 5: streaming serving (chunk {CHUNK}, {LEFT} left chunks)")
    for src, (model, ffn) in itertools.product(("fixture", "synthetic"),
                                               ((gpu32, False), (gpu32f, True))):
        w, wl = data[src]
        feats, flens = fbank_batch(w, wl, cfg32.feature, device=dev)
        full, full_lens = model.encode(feats, flens, CHUNK, LEFT)
        n = num_chunks(feats.shape[1], CHUNK, 4, 6)
        # streaming sees whole chunks and never masks padding: decode the
        # frames of the whole chunks inside each request's valid length
        whole = torch.clamp(full_lens.long(), max=n * CHUNK) // CHUNK * CHUNK
        off_t, off_l = rnnt_greedy_decode(model, full, whole, cfg32.model.blank_id)
        st_t, st_l, _ = streaming_greedy_decode(model, feats, whole * 4 + 3, CHUNK, LEFT,
                                                cfg32.model.blank_id)
        ok = torch.equal(st_t, off_t) and torch.equal(st_l, off_l)
        print(f"streaming == chunk-masked offline on {src}, fused_ffn={ffn} "
              f"({int(whole.sum())} frames, {int(st_l.sum())} tokens): {ok}")
        require(ok, f"streaming tokens differ from chunk-masked offline ({src}, "
                    f"fused_ffn={ffn})")

    feats16, _ = fbank_batch(*data["synthetic"], cfg16.feature, device=dev)
    for label, model, cfg in (("bf16", gpu16, cfg16), ("fp32", gpu32, cfg32)):
        st = measure_rtf(model, feats16, cfg, "greedy")
        print(f"streaming RTF {label} (4 streams, {st.n_chunks} chunks of "
              f"{st.chunk_audio_seconds:.3f} s): p50 {st.rtf_p50:.5f} p90 {st.rtf_p90:.5f} "
              f"(probe p50 {st.probe_p50_ms:.4f} ms) on {st.device}")
        serving[f"rtf_p50_{label}"] = st.rtf_p50
        serving[f"rtf_p90_{label}"] = st.rtf_p90
        serving[f"rtf_probe_p50_ms_{label}"] = st.probe_p50_ms
    serving["stream_bf16_chunk_stages"] = _stream_stages(torch, gpu16, cfg16, feats16)
    return serving, {"gpu32": gpu32, "cpu32": cpu32, "gpu32f": gpu32f, "gpu16": gpu16,
                     "cfg32": cfg32, "cfg32f": cfg32f, "cfg16": cfg16, "bias": bias,
                     "feats16": feats16}


def _fit_ctc_blank_bias(torch, model, enc, elens, target: float) -> float:
    """Set the CTC head's blank logit (bisection on [0, 16]) so that CTC
    greedy search emits `target` tokens per encoder frame, as the joint's
    was fitted; -> the bias. A random CTC head otherwise emits at nearly
    every frame."""
    from tpuasr_torch.decode import ctc_greedy_decode

    # the transducer's CTC head, or the AED model's
    bias = (model.ctc.ctc_lo if hasattr(model, "ctc") else model.ctc_lo).bias
    blank = model.cfg.blank_id

    def rate(b: float) -> float:
        with torch.no_grad():
            bias[blank] = b
        lp = torch.log_softmax(model.ctc_logits(enc).float(), dim=-1)
        return float(ctc_greedy_decode(lp, elens, blank)[1].sum()) / float(elens.sum())

    free = rate(0.0)
    lo, hi = 0.0, 16.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if rate(mid) > target else (lo, mid)
    got = rate(hi)
    print(f"CTC blank logit bias {hi:.4f}: {got:.4f} tokens per encoder frame by ctc_greedy, "
          f"target {target:.4f}; {free:.4f} with no bias")
    return hi


def _hyps(toks, lens, scores) -> list[dict]:
    """Per request: {token tuple: score} of the live n-best slots."""
    out = []
    for t, l, s in zip(toks.tolist(), lens.tolist(), scores.tolist()):
        out.append({tuple(ti[:li]): si for ti, li, si in zip(t, l, s) if si > -1e29})
    return out


def _nbest_agreement(torch, label, card, cpu, max_inside: int = 4) -> dict:
    """Card against CPU for a beam mode: card, cpu = (n-best tokens [B, N,
    U], lens [B, N], scores [B, N]), or a list of such batches. d is the largest |card - CPU| score of
    the hypotheses both found; each request whose CPU margin between its
    best and second-best score exceeds 2d must have the same best
    hypothesis on the card. Requests inside the margin are printed; more
    than `max_inside` of them fail the check (it would say nothing)."""
    # one (tokens, lens, scores) triple, or a list of them (one a batch)
    rows = lambda x: [h for b in (x if isinstance(x, list) else [x])
                      for h in _hyps(*(t.cpu() for t in b))]
    hc, hp = rows(card), rows(cpu)
    d = max((abs(a[h] - b[h]) for a, b in zip(hc, hp) for h in a.keys() & b.keys()),
            default=0.0)
    inside, same = [], 0
    for i, (a, b) in enumerate(zip(hc, hp)):
        ranked = sorted(b.values(), reverse=True)
        margin = ranked[0] - ranked[1] if len(ranked) > 1 else math.inf
        if margin <= 2 * d:
            inside.append((i, margin))
            continue
        best_c, best_p = max(a, key=a.get), max(b, key=b.get)
        require(best_c == best_p, f"{label}: request {i}'s best hypothesis differs on the "
                                  f"card (CPU margin {margin:.4g} > 2d = {2 * d:.4g})")
        same += 1
    both = sum(len(a.keys() & b.keys()) for a, b in zip(hc, hp))
    emitted = sum(len(max(b, key=b.get)) for b in hp)
    print(f"{label}: d = {d:.3g} (the largest |card - CPU| score over {both} hypotheses "
          f"both found); {same} requests outside 2d, same best hypothesis ({emitted} tokens "
          f"in the CPU's best); inside 2d (request, CPU margin): "
          f"{[(i, round(mg, 6)) for i, mg in inside]}")
    require(len(inside) <= max_inside, f"{label}: {len(inside)} requests within 2d of a tie: "
                                       f"the check would be empty")
    return {"d": d, "hypotheses_both": both, "same_outside_2d": same, "inside_2d": inside,
            "cpu_best_tokens": emitted}


def _serve_modes(torch, dev, data, m) -> dict:
    """Phase 4b: the flagship through make_offline_decoder's other modes
    (rnnt_beam with CTC fusion 0 and 0.3, ctc_greedy, ctc_prefix_beam with
    and without a context graph, rnnt_rescoring), fp32 on the card against
    the CPU, then each mode's latency in fp32 and bf16."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import (
        build_context_graph, ctc_greedy_decode, ctc_prefix_beam_search, rnnt_beam_decode,
        transducer_rescoring,
    )
    from tpuasr_torch.decode.rnnt_beam import first_argmax
    from tpuasr_torch.eval import make_offline_decoder
    from tpuasr_torch.tools.profile_trace import synced_ms

    t0 = time.perf_counter()
    print("== phase 4b: the other offline modes (make_offline_decoder)")
    gpu32, cpu32, cfg32 = m["gpu32"], m["cpu32"], m["cfg32"]
    c = cfg32.model
    blank, tw, cw = c.blank_id, c.transducer_weight, c.ctc_weight
    waves, wave_lens = data["fixture"]
    enc = {}
    for side, model in (("card", gpu32), ("cpu", cpu32)):
        feats, flens = fbank_batch(waves, wave_lens, cfg32.feature, device=model.device)
        enc[side] = model.encode(feats, flens)
    target = float(data["text_lens"].sum()) / float(enc["cpu"][1].sum())
    ctc_bias = _fit_ctc_blank_bias(torch, gpu32, *enc["card"], target)
    for model in (cpu32, m["gpu32f"], m["gpu16"]):
        with torch.no_grad():
            model.ctc.ctc_lo.bias[blank] = ctc_bias

    def searches(model, e, el, graph=None):
        """Every mode's search on one side's encoder output -> {mode:
        (n-best tokens, lens, scores) or (tokens, lens) for ctc_greedy}."""
        lp = torch.log_softmax(model.ctc_logits(e).float(), dim=-1)
        out = {f"rnnt_beam_fusion_{w}": rnnt_beam_decode(model, e, el, blank, 4, 200,
                                                         ctc_weight=w, transducer_weight=tw)[2:]
               for w in (0.0, 0.3)}
        out["ctc_greedy"] = ctc_greedy_decode(lp, el, blank)
        out["ctc_prefix_beam"] = ctc_prefix_beam_search(lp, el, blank, 4, 200)[2]
        if graph is not None:
            out["ctc_prefix_beam_graph"] = ctc_prefix_beam_search(lp, el, blank, 4, 200,
                                                                  context_graph=graph)[2]
        out["rnnt_rescoring"] = out["ctc_prefix_beam"][:2] + (transducer_rescoring(
            model, e, el, *out["ctc_prefix_beam"], blank, tw, cw)[2],)
        return out

    cpu = searches(cpu32, *enc["cpu"])
    # hotwords: 2-token spans of the CPU's unbiased best hypotheses
    words = []
    for h in _hyps(*cpu["ctc_prefix_beam"]):
        best = list(max(h, key=h.get))
        words += [best[i:i + 2] for i in range(0, len(best) - 1, 4)]
    graph = build_context_graph(words, c.vocab_size, 2.0)
    cpu["ctc_prefix_beam_graph"] = ctc_prefix_beam_search(
        torch.log_softmax(cpu32.ctc_logits(enc["cpu"][0]).float(), dim=-1), enc["cpu"][1],
        blank, 4, 200, context_graph=graph)[2]
    moved = int((cpu["ctc_prefix_beam_graph"][2] != cpu["ctc_prefix_beam"][2]).any(1).sum())
    print(f"context graph: {len(words)} hotwords of 2 tokens, {graph.num_nodes} states; "
          f"it moved the n-best scores of {moved} of {len(wave_lens)} requests")
    require(moved > 0, "the context graph never fired")
    card = searches(gpu32, *enc["card"], graph)

    same = all(torch.equal(a.cpu(), b) for a, b in zip(card["ctc_greedy"], cpu["ctc_greedy"]))
    print(f"ctc_greedy card vs CPU on {len(wave_lens)} requests: tokens identical {same} "
          f"(emitted {int(cpu['ctc_greedy'][1].sum())})")
    require(same, "ctc_greedy tokens on the card differ from the CPU run")
    out = {"ctc_blank_logit_bias": ctc_bias, "agreement": {}}
    for mode in ("rnnt_beam_fusion_0.0", "rnnt_beam_fusion_0.3", "ctc_prefix_beam",
                 "ctc_prefix_beam_graph", "rnnt_rescoring"):
        out["agreement"][mode] = _nbest_agreement(torch, mode, card[mode], cpu[mode])

    # the entry points: make_offline_decoder on the card gives the searches'
    # best hypotheses
    decoders = {
        "rnnt_beam_fusion_0.0": ("rnnt_beam", {}), "rnnt_beam_fusion_0.3":
        ("rnnt_beam", {"ctc_fusion_weight": 0.3}), "ctc_greedy": ("ctc_greedy", {}),
        "ctc_prefix_beam": ("ctc_prefix_beam", {}), "rnnt_rescoring": ("rnnt_rescoring", {})}
    for name, (mode, kw) in decoders.items():
        toks, lens = make_offline_decoder(gpu32, cfg32, mode, **kw)(waves, wave_lens)
        if name == "ctc_greedy":
            ref_t, ref_l = card[name]
        else:
            nb_t, nb_l, nb_s = card[name]
            rows = torch.arange(nb_t.shape[0], device=dev)
            pick = first_argmax(nb_s, 1)
            ref_t, ref_l = nb_t[rows, pick], nb_l[rows, pick]
        require(torch.equal(toks, ref_t) and torch.equal(lens, ref_l),
                f"make_offline_decoder({mode!r}) differs from its search on the card")

    # latency: one warm-up call, then one synced call
    graph_dec = _graph_decoder(torch, graph)
    lat = {}
    for label, model, cfg in (("fp32", gpu32, cfg32), ("bf16", m["gpu16"], m["cfg16"])):
        for src in ("fixture", "synthetic"):
            w, wl = data[src]
            for name, (mode, kw) in decoders.items():
                dec = make_offline_decoder(model, cfg, mode, **kw)
                dec(w, wl)
                _, ms = synced_ms(dev, lambda: dec(w, wl))
                lat[f"{name}_{label}_{src}"] = ms
            dec = graph_dec(model, cfg)
            dec(w, wl)
            lat[f"ctc_prefix_beam_graph_{label}_{src}"] = synced_ms(dev, lambda: dec(w, wl))[1]
    for k, v in lat.items():
        print(f"  offline latency {k}: {v:.1f} ms")
    out["latency_ms"] = lat
    dec = make_offline_decoder(gpu32, cfg32, "rnnt_beam")
    out["rnnt_beam_fp32_fixture_device_busy_ms"] = _decode_busy(torch, dec, waves,
                                                                wave_lens)[0]
    print(f"rnnt_beam fp32 on the fixture: device busy "
          f"{out['rnnt_beam_fp32_fixture_device_busy_ms']:.2f} ms (profiler) of a "
          f"{lat['rnnt_beam_fusion_0.0_fp32_fixture']:.1f} ms request batch")
    print(f"(phase 4b: {time.perf_counter() - t0:.1f} s)")
    return out


def _graph_decoder(torch, graph):
    """-> decoder(model, cfg): waves -> ctc_prefix_beam_search with the
    context graph (make_offline_decoder's ctc_prefix_beam takes none)."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import ctc_prefix_beam_search

    def make(model, cfg):
        @torch.no_grad()
        def decode(waves, wave_lens):
            feats, flens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
            e, el = model.encode(feats, flens)
            lp = torch.log_softmax(model.ctc_logits(e).float(), dim=-1)
            return ctc_prefix_beam_search(lp, el, model.cfg.blank_id, 4, 200,
                                          context_graph=graph)[:2]
        return decode

    return make


def _serve_stream_beam(torch, dev, data, m) -> dict:
    """Phase 5b: streaming beam == offline beam over the chunk-masked
    full-context encoder (fixture and synthetic, fused_ffn off and on, one
    emission a frame, and streaming.n_steps with CTC fusion 0.3); beam RTF
    on the synthetic batch beside greedy's, with its expansion sub-steps a
    frame; the first-token delay of the fixture requests."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_beam_decode, streaming_beam_decode
    from tpuasr_torch.eval import measure_first_token_delay, measure_rtf
    from tpuasr_torch.streaming import num_chunks
    from tpuasr_torch.tools.profile_trace import synced_ms

    t0 = time.perf_counter()
    print(f"== phase 5b: streaming beam (chunk {CHUNK}, {LEFT} left chunks, beam 4)")
    cfg32 = m["cfg32"]
    c = cfg32.model
    out = {}
    for src, (model, ffn) in itertools.product(("fixture", "synthetic"),
                                               ((m["gpu32"], False), (m["gpu32f"], True))):
        w, wl = data[src]
        feats, flens = fbank_batch(w, wl, cfg32.feature, device=dev)
        full, full_lens = model.encode(feats, flens, CHUNK, LEFT)
        n = num_chunks(feats.shape[1], CHUNK, 4, 6)
        whole = torch.clamp(full_lens.long(), max=n * CHUNK) // CHUNK * CHUNK
        for n_steps, cw in ((1, 0.0), (cfg32.streaming.n_steps, 0.3)):
            off = rnnt_beam_decode(model, full, whole, c.blank_id, 4, 200, n_steps=n_steps,
                                   ctc_weight=cw, transducer_weight=c.transducer_weight)
            (st_t, st_l, _), ms = synced_ms(dev, lambda: streaming_beam_decode(
                model, feats, whole * 4 + 3, CHUNK, LEFT, c.blank_id, 4, 200, n_steps, cw,
                c.transducer_weight))
            ok = torch.equal(st_t, off[0]) and torch.equal(st_l, off[1])
            print(f"streaming beam == chunk-masked offline beam on {src}, fused_ffn={ffn}, "
                  f"n_steps {n_steps}, CTC fusion {cw} ({int(whole.sum())} frames, "
                  f"{int(st_l.sum())} tokens, {int(off[3].sum())} in the n-best): {ok}; "
                  f"streaming {ms:.1f} ms")
            require(ok, f"streaming beam tokens differ from chunk-masked offline beam ({src}, "
                        f"fused_ffn={ffn}, n_steps {n_steps}, fusion {cw})")
    feats16 = m["feats16"]
    fx_feats, fx_lens = fbank_batch(*data["fixture"], cfg32.feature, device=dev)
    for label, model, cfg in (("bf16", m["gpu16"], m["cfg16"]), ("fp32", m["gpu32"], cfg32)):
        steps, restore = _count_steps(model)
        try:
            st = measure_rtf(model, feats16, cfg, "beam", beam_size=cfg.streaming.beam_size,
                             n_steps=cfg.streaming.n_steps)
        finally:
            restore()
        # measure_rtf runs the warm-up chunks and then every chunk
        frames = (st.n_chunks + min(2, st.n_chunks)) * cfg.streaming.chunk_size
        print(f"streaming beam RTF {label} (4 streams, beam {cfg.streaming.beam_size}, n_steps "
              f"{cfg.streaming.n_steps}, {st.n_chunks} chunks of {st.chunk_audio_seconds:.3f} s): "
              f"p50 {st.rtf_p50:.5f} p90 {st.rtf_p90:.5f} (probe p50 {st.probe_p50_ms:.4f} ms); "
              f"{steps[0]} expansion sub-steps over {frames} frames, one host sync each after "
              f"a frame's first")
        out[f"beam_rtf_p50_{label}"], out[f"beam_rtf_p90_{label}"] = st.rtf_p50, st.rtf_p90
        out[f"beam_rtf_probe_p50_ms_{label}"] = st.probe_p50_ms
        out[f"beam_rtf_substeps_per_frame_{label}"] = steps[0] / frames
        ftd = measure_first_token_delay(model, fx_feats, fx_lens, cfg)
        print(f"first-token delay {label} (streaming greedy, the {len(fx_lens)} fixture "
              f"requests): p50 {ftd['p50_first_token_delay_s']:.4f} s, p90 "
              f"{ftd['p90_first_token_delay_s']:.4f} s, emitted {ftd['emitted_fraction']:.2f}")
        out[f"first_token_delay_{label}"] = ftd
    print(f"(phase 5b: {time.perf_counter() - t0:.1f} s)")
    return out


def _serving_lattice_record(torch, seen, launches) -> dict:
    """#8 against its plain version on the inputs rnnt_rescoring gave it on
    the card in the serving run, at each signature (the recorded calls must
    be the run's launches); -> the record at the signature launched most,
    every signature's under "shapes"."""
    # the CPU reference's calls take the plain version and launch nothing
    calls = {k: v for k, v in seen.get("rnnt_alpha", {}).items() if v[1]["blank_lp"].is_cuda}
    n = sum(c for c, _ in calls.values())
    require(n == launches["rnnt_alpha"], f"the serving run launched rnnt_alpha "
                                         f"{launches['rnnt_alpha']} times but its wrapper "
                                         f"was called {n} times")
    shapes = [dict(_hold(torch, "rnnt_alpha", args, f"serving, {count} calls at"),
                   calls=count) for count, args in sorted(calls.values(), key=lambda x: -x[0])]
    return dict(shapes[0], shapes=[
        {k: s[k] for k in ("inputs", "calls", "max_abs_err", "tol", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")} for s in shapes])


def _count_steps(model):
    """Count predictor steps (= emission-loop iterations, one host sync
    each) by wrapping the predictor's forward_step, which greedy and beam
    search call; -> (counter, restore)."""
    steps = [0]
    step = model.predictor.forward_step

    def counted(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    model.predictor.forward_step = counted
    return steps, lambda: delattr(model.predictor, "forward_step")


def _decode_busy(torch, dec, *args) -> tuple[float, list]:
    """The device's busy ms over one call dec(*args), an offline decode or
    a streaming chunk (torch.profiler), and its device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dec(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kern) / 1e3, kern


def _fbank_route_ab(torch, model, cfg, waves, wave_lens) -> dict:
    """The offline fp32 request batch's device busy ms with "highest" fbank
    by the FFT route and by the dense kernel (the plan fixed to it), in
    turns (FFT, dense, dense, FFT) in this process, after the serving run's
    launches are read; -> {route: [ms, ms]}."""
    import tpuasr_torch.ops.fbank as fbank_mod
    from tpuasr_torch.eval import make_offline_decoder

    dec = make_offline_decoder(model, cfg, "rnnt_greedy")
    real, busy = fbank_mod._fbank_fft_plan, {"fbank_fft": [], "fbank_fp32": []}
    try:
        for route in ("fbank_fft", "fbank_fp32", "fbank_fp32", "fbank_fft"):
            fbank_mod._fbank_fft_plan = real if route == "fbank_fft" else \
                (lambda r, *a: {"route": "fbank_fp32"})
            dec(waves, wave_lens)  # warm
            busy[route].append(_decode_busy(torch, dec, waves, wave_lens)[0])
    finally:
        fbank_mod._fbank_fft_plan = real
    mean = {k: sum(v) / len(v) for k, v in busy.items()}
    print(f"offline fp32 request batch, device busy ms by fbank route (in turns FFT, dense, "
          f"dense, FFT): FFT {busy['fbank_fft']}, the dense kernel {busy['fbank_fp32']}; "
          f"means {mean['fbank_fft']:.3f} / {mean['fbank_fp32']:.3f}, change "
          f"{mean['fbank_fft'] - mean['fbank_fp32']:+.3f} ms")
    return busy


def _offline_stages(torch, model, cfg, waves, wave_lens, wall_ms) -> dict:
    """Where the offline request time goes: host ms of fbank, encoder and
    greedy search (each closed by a sync), the greedy loop's emission steps,
    and the device's busy time from the profiler over one whole decode."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_greedy_decode
    from tpuasr_torch.eval import make_offline_decoder
    from tpuasr_torch.tools.profile_trace import synced_ms

    steps, restore = _count_steps(model)
    try:
        (feats, flens), t_fb = synced_ms(
            model.device, lambda: fbank_batch(waves, wave_lens, cfg.feature,
                                              device=model.device))
        (enc, elens), t_enc = synced_ms(model.device, lambda: model.encode(feats, flens))
        _, t_dec = synced_ms(model.device, lambda: rnnt_greedy_decode(
            model, enc, elens, cfg.model.blank_id))
    finally:
        restore()
    busy_ms, kern = _decode_busy(torch, make_offline_decoder(model, cfg, "rnnt_greedy"),
                                 waves, wave_lens)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    print(f"offline fp32 stages: fbank {t_fb:.2f} ms, encode {t_enc:.2f} ms, greedy "
          f"{t_dec:.2f} ms over {steps[0]} emission steps (one host sync each); device "
          f"busy {busy_ms:.2f} ms (profiler) of a {wall_ms:.1f} ms request batch")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return {"fbank_ms": t_fb, "encode_ms": t_enc, "greedy_ms": t_dec,
            "emission_steps": steps[0], "device_busy_ms": busy_ms}


def _stream_stages(torch, model, cfg, feats) -> dict:
    """Per-chunk host ms of the chunk encoder and of greedy search."""
    from tpuasr_torch.decode import greedy_frames, init_streaming_state
    from tpuasr_torch.streaming import chunk_windows, num_chunks
    from tpuasr_torch.tools.profile_trace import synced_ms

    chunk, left, blank = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks, \
        cfg.model.blank_id
    n = num_chunks(feats.shape[1], chunk, 4, 6)
    windows = chunk_windows(feats, chunk, 4, 6, n)
    state = init_streaming_state(model, feats.shape[0], chunk, left, blank)
    enc_state, dec = state.enc, state.dec
    t_enc, t_dec = [], []
    steps, restore = _count_steps(model)
    try:
        for i in range(n):
            (ys, enc_state), te = synced_ms(model.device, lambda: model.encode_chunk(windows[i],
                                                                               enc_state))
            valid = torch.ones(ys.shape[:2], dtype=torch.bool, device=ys.device)
            dec, td = synced_ms(model.device, lambda: greedy_frames(model, ys, valid, dec, blank,
                                                              cfg.streaming.n_steps))
            t_enc.append(te)
            t_dec.append(td)
    finally:
        restore()
    res = {"encode_chunk_ms_median": sorted(t_enc)[n // 2],
           "greedy_ms_median": sorted(t_dec)[n // 2], "emission_steps": steps[0],
           "chunks": n}
    print(f"streaming bf16 per chunk (median of {n}): encode_chunk "
          f"{res['encode_chunk_ms_median']:.2f} ms, greedy {res['greedy_ms_median']:.2f} ms; "
          f"{steps[0]} emission steps in all")
    return res


# ---------------------------------------------------------------------------
# training: kernels #4-#9 and phase 6
# ---------------------------------------------------------------------------

BENCH_B, BENCH_FRAMES, BENCH_TOKENS = 12, 768, 32  # bench.py:78-80
HOP, SR = 512, 48000


def _enc_len(wave_lens):
    """Encoder frames of waves: fbank frames 1 + n // hop, then rate-4
    subsampling."""
    f = 1 + wave_lens // HOP
    return ((f - 1) // 2 - 1) // 2


def _train_kernel_checks(torch, dev, bench) -> tuple[dict, dict]:
    """Kernels #4-#9 against their plain versions at the training step's
    shapes (and a ragged shape with a t_len = 0 and a label_len = 0 row);
    -> ({name: record at the bench shape}, {shape: #4's plan there})."""
    import numpy as np
    import torch.nn.functional as F

    from tpuasr_torch.losses.ctc import lattice_inputs
    from tpuasr_torch.ops import (
        ctc_alpha_plain, ctc_beta_grad, rnnt_alpha_plain, rnnt_beta_grad_plain, rnnt_fused_grads,
        rnnt_fused_lp,
    )
    from tpuasr_torch.ops.rnnt_lattice import mask_lattice_inputs

    out, plans = {}, {}  # plans: #4's at each shape, kept out of the kernels line
    blank = 5
    wave_lens = bench["wave_lens"].cpu().numpy()
    bench_t = int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    shapes = (("bench", BENCH_B, bench_t, BENCH_TOKENS, 256, 412, _enc_len(wave_lens),
               bench["text_lens"].cpu().numpy()),
              ("ragged", 3, 37, 5, 256, 97, np.array([37, 0, 20]), np.array([5, 3, 0])))
    g = torch.Generator().manual_seed(SEED)
    for tag, b, t, u, d, v, t_lens, u_lens in shapes:
        enc = torch.randn(b, t, d, generator=g).to(dev)
        pred = torch.randn(b, u + 1, d, generator=g).to(dev)
        w = (torch.randn(d, v, generator=g) / math.sqrt(d)).to(dev)
        bias = (0.1 * torch.randn(v, generator=g)).to(dev)
        lab = torch.randint(0, v - 1, (b, u), generator=g)
        lab = (lab + (lab >= blank).long()).to(torch.int32).to(dev)  # never the blank
        tl = torch.as_tensor(t_lens, dtype=torch.int32).to(dev)
        ul = torch.as_tensor(u_lens, dtype=torch.int32).to(dev)
        recs = {}
        joint = dict(enc_p=enc, pred_p=pred, w=w, b=bias, labels=lab)

        # #4: blank/label log-probs and the logsumexp; #8 / #9: the lattice
        # over the fused route's masked log-probs (the materialized route
        # hands the lattice the same [B, T, U+1] inputs)
        recs["rnnt_fused_fwd"] = _hold(torch, "rnnt_fused_fwd", dict(joint, blank=blank), tag)
        blank_lp, label_full, lse = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
        again = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip((blank_lp, label_full, lse), again)),
                f"two calls of rnnt_fused_lp on the same inputs differ ({tag})")
        plans[tag] = _joint_fwd_plan_line(torch, enc, pred, w, tag)
        msg = f"rnnt_fused_fwd {tag}: two calls bit-identical"
        if tag == "bench":
            split = _device_split(torch, lambda: rnnt_fused_lp(enc, pred, w, bias, lab, blank))
            recs["rnnt_fused_fwd"]["device_split_ms"] = split
            msg += "; device ms a call by kernel (profiler): " + "; ".join(
                f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1]))
        print(msg)
        if tag == "bench":
            for tt in (63, 127):  # the trainer's T' at its batch of 12, U+1 17
                trainer = dict(enc_p=enc[:, :tt].contiguous(), pred_p=pred[:, :17].contiguous(),
                               w=w, b=bias, labels=lab[:, :16].contiguous(), blank=blank)
                rec = _hold(torch, "rnnt_fused_fwd", trainer, f"T'{tt}")
                plans[f"T'{tt}"] = _joint_fwd_plan_line(torch, trainer["enc_p"],
                                                        trainer["pred_p"], w, f"T'{tt}")
                recs["rnnt_fused_fwd"][f"trainer_shape_t{tt}"] = rec
        bm, lm, pad_t, lv = mask_lattice_inputs(blank_lp, label_full[:, :, :-1], tl, ul)
        # #8 / #9 on each route; at the bench shape also at the trainer's
        # shapes (T' 63 / 127, U+1 17), cut from the same log-probs
        rnnt_shapes = [(tag, bm, lm, ul)]
        if tag == "bench":
            for tt in (63, 127):
                cut = mask_lattice_inputs(blank_lp[:, :tt, :17], label_full[:, :tt, :16],
                                          torch.clamp(tl, max=tt), torch.clamp(ul, max=16))
                rnnt_shapes.append((f"T'{tt}", cut[0].contiguous(), cut[1].contiguous(),
                                    torch.clamp(ul, max=16)))
        for shape, bm_s, lm_s, ul_s in rnnt_shapes:
            lattice = dict(blank_lp=bm_s, label_lp=lm_s, u_lens=ul_s)
            ra, rll = rnnt_alpha_plain(*lattice.values())
            beta = dict(lattice, alpha=ra.contiguous(), ll=rll.contiguous(),
                        g=(0.5 + torch.rand(b, generator=g)).to(dev))
            pair = _lattice_routes(torch, "rnnt", lattice, beta, shape, {})
            if shape == tag:
                recs.update(pair)
            else:
                for name in pair:
                    recs[name][f"trainer_shape_t{shape[2:]}"] = pair[name]
        ra, rll = rnnt_alpha_plain(bm, lm, ul)

        # #5: gradients from the lattice's occupancies (mean over B)
        zero = torch.zeros((), device=dev)
        occ_b, occ_l = rnnt_beta_grad_plain(bm, lm, ul, ra, rll, torch.ones(b, device=dev))
        gb = torch.where(pad_t, zero, -occ_b / b).contiguous()
        gl = F.pad(torch.where(lv, -occ_l / b, zero), (0, 1)).contiguous()
        bwd = dict(joint, lse=lse, gb=gb, gl=gl, blank=blank)
        recs["rnnt_fused_bwd"] = _hold(torch, "rnnt_fused_bwd", bwd, tag)
        first, again = rnnt_fused_grads(*bwd.values()), rnnt_fused_grads(*bwd.values())
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(first, again)),
                f"two calls of rnnt_fused_bwd on the same inputs differ ({tag})")
        msg = f"rnnt_fused_bwd {tag}: two calls bit-identical"
        if tag == "bench":
            split = _device_split(torch, lambda: rnnt_fused_grads(*bwd.values()))
            recs["rnnt_fused_bwd"]["device_split_ms"] = split
            msg += "; device ms a call by kernel (profiler): " + "; ".join(
                f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1]))
        print(msg)

        # #6 / #7: the CTC lattice over log-softmaxed logits, on each route;
        # at the bench shape also at the trainer's shapes (T' 63 / 127, U+1
        # 17)
        lp = torch.log_softmax(torch.randn(b, t, v, generator=g).to(dev), dim=-1)
        ctc_shapes = [(tag, lp, lab, ul, tl)]
        if tag == "bench":
            ctc_shapes += [(f"T'{tt}", lp[:, :tt], lab[:, :16].contiguous(),
                            torch.clamp(ul, max=16), torch.clamp(tl, max=tt)) for tt in (63, 127)]
        for shape, lp_s, lab_s, ul_s, tl_s in ctc_shapes:
            lp_states, skip, final = lattice_inputs(lp_s, lab_s, ul_s, blank)
            ctc = dict(lp_states=lp_states.contiguous(), skip=skip, tlens=tl_s, final=final)
            ra, rll = ctc_alpha_plain(*ctc.values())
            beta = dict(ctc, alpha=ra.contiguous(), ll=rll.contiguous(),
                        g=(0.5 + torch.rand(b, generator=g)).to(dev))
            # F.ctc_loss on the same log-probs and labels (not at the ragged
            # shape, whose t_len = 0 row it is not asked to take)
            lib = {} if shape == "ragged" else {
                0: [1, dict(log_probs=lp_s, labels=lab_s, label_lens=ul_s, blank=blank)]}
            pair = _lattice_routes(torch, "ctc", ctc, beta, shape, lib)
            if shape == tag:
                recs.update(pair)
            else:
                for name in pair:
                    recs[name][f"trainer_shape_t{shape[2:]}"] = pair[name]
            if shape == "ragged":
                require(bool((ctc_beta_grad(*beta.values())[1] == 0).all()),
                        "ctc_beta_grad: a t_len = 0 row has gradient")
        if tag == "bench":
            out = recs
    return out, plans


# each lattice's wrapper module, plan, kernels and the kernel symbols of its
# source (for the device time by route in a profiled step)
LATTICES = {"ctc": ("tpuasr_torch.ops.ctc", "_ctc_plan", ("ctc_alpha", "ctc_beta_grad"),
                    r"::ctc_\w+_kernel"),
            "rnnt": ("tpuasr_torch.ops.rnnt_lattice", "_rnnt_plan",
                     ("rnnt_alpha", "rnnt_beta_grad"), r"::rnnt_(alpha|beta_grad)\w*_kernel")}


@contextlib.contextmanager
def _plan_as(kind: str, route: str):
    """Run a lattice's wrappers (`kind` "ctc" or "rnnt") on `route` (the
    wrappers choose by shape alone)."""
    import importlib

    modname, plan_name, _, _ = LATTICES[kind]
    mod = importlib.import_module(modname)
    real = getattr(mod, plan_name)
    setattr(mod, plan_name, lambda *args: real(*args, route=route))
    try:
        yield
    finally:
        setattr(mod, plan_name, real)


def _lattice_routes(torch, kind, fwd, bwd, tag, lib) -> dict:
    """A lattice's kernels (#6 / #7 for kind "ctc", #8 / #9 for "rnnt") at
    one shape, held against their plain versions on the route the plan
    takes (the warp route at every shape of the path) and on the block
    route; -> {name: the plan's route's record}, each with its time per
    dependent step (CTC: ms / the longest t_len; RNN-T: ms / the T + U
    anti-diagonals), two calls bit-identical, its device time by kernel, and
    the block route's record and both routes timed in turns (block, warp,
    warp, block)."""
    import importlib

    modname, plan_name, names, _ = LATTICES[kind]
    mod = importlib.import_module(modname)
    if kind == "ctc":
        width, steps = fwd["lp_states"].shape[2], max(int(fwd["tlens"].max()), 1)
    else:
        _, t, width = fwd["blank_lp"].shape
        steps = t + width - 1
    ghz = _sm_ghz(torch)
    out = {}
    for name, args in zip(names, (fwd, bwd)):
        # the RNN-T plan chooses each entry's route apart
        plan_args = (width,) if kind == "ctc" else (width, name.removeprefix("rnnt_"))
        route = getattr(mod, plan_name)(*plan_args)["route"]
        fn = getattr(mod, name)
        call = lambda: fn(*args.values())
        rec = _hold(torch, name, args, f"{tag}, {route} route", lib)
        first, again = call(), call()
        torch.cuda.synchronize()
        first, again = ((x,) if isinstance(x, torch.Tensor) else x for x in (first, again))
        require(all(torch.equal(x, y) for x, y in zip(first, again)),
                f"two calls of {name} on the same inputs differ ({tag})")
        split = _device_split(torch, call)
        with _plan_as(kind, route="block"):
            block = _hold(torch, name, args, f"{tag}, block route", lib)
            block_split = _device_split(torch, call)
        turns = {"block": [], route: []}
        for r in ("block", route, route, "block"):
            with _plan_as(kind, route=r):
                turns[r].append(_time_ms(torch, call))
        rec.update(plan_route=route, us_per_step=rec["ms"] / steps * 1e3, steps=steps,
                   sm_ghz=ghz, cycles_per_step=rec["ms"] / steps * ghz * 1e6,
                   bits_identical=True, device_split_ms=split, turns_ms=turns,
                   block_route=dict(block, us_per_step=block["ms"] / steps * 1e3,
                                    device_split_ms=block_split))
        print(f"{name} {tag}: {route} route {rec['ms']:.4f} ms, {rec['us_per_step']:.4f} us a "
              f"dependent step ({steps} steps; {rec['cycles_per_step']:.0f} cycles at the "
              f"{ghz:.3f} GHz a sleep kernel shows); block route {block['ms']:.4f} ms, "
              f"{rec['block_route']['us_per_step']:.4f} us a step; in turns (block, {route}, "
              f"{route}, block) {turns['block'][0]:.4f} {turns[route][0]:.4f} "
              f"{turns[route][1]:.4f} {turns['block'][1]:.4f}; two calls bit-identical; "
              f"device ms a call by kernel (profiler): " + "; ".join(
                  f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1])))
        out[name] = rec
    return out


def rnnt_lattice_inputs(torch, dev, b, t, u1, t_lens, u_lens, seed) -> dict:
    """Masked RNN-T lattice inputs on the card, as the loss hands them to
    #8: blank_lp [B, T, U+1] and label_lp [B, T, U] a log-softmax over 64
    classes of normal logits (the label's a random class's), masked by
    `mask_lattice_inputs`, and u_lens [B] int32."""
    from tpuasr_torch.ops.rnnt_lattice import mask_lattice_inputs

    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(torch.randn(b, t, u1, 64, generator=g, device=dev), -1)
    lab = torch.randint(1, 64, (b, u1 - 1), generator=g, device=dev)
    label = lp[:, :, :u1 - 1].gather(3, lab[:, None, :, None].expand(b, t, u1 - 1, 1))[..., 0]
    tl = torch.as_tensor(t_lens, dtype=torch.int32, device=dev)
    ul = torch.as_tensor(u_lens, dtype=torch.int32, device=dev)
    bm, lm, _, _ = mask_lattice_inputs(lp[..., 0], label, tl, ul)
    return dict(blank_lp=bm.contiguous(), label_lp=lm.contiguous(), u_lens=ul)


def _rnnt_route_sweep(torch, dev) -> dict:
    """#8 and #9 by route at U+1 = 32K for every K of the warp route (1 ..
    8), every label sequence U long, at the bench's B 12 and T' 191 and at
    B 4 and T' 60 (fewer frames than labels at K >= 2): each route timed in
    turns (block, warp, warp, block), the warp route's outputs held against
    the block route's with phase 3's tolerances (#9 on the block route's
    alpha and ll). The plan's route for each entry is printed beside the
    times: this is the reading behind `_rnnt_plan`'s cut-over at K 8. ->
    {"b<B>_t<T>_u1_<U+1>": {name: {"warp": [ms, ms], "block": [ms, ms],
    "plan": route}}}."""
    import importlib

    rl = importlib.import_module("tpuasr_torch.ops.rnnt_lattice")  # the module, not the function
    out = {}
    for (b, t), k in itertools.product(((BENCH_B, 191), (4, 60)), range(1, rl.MAX_K + 1)):
        u1 = 32 * k
        fwd = rnnt_lattice_inputs(torch, dev, b, t, u1, [t] * b, [u1 - 1] * b, SEED + k)
        with _plan_as("rnnt", route="block"):
            alpha, ll = rl.rnnt_alpha(*fwd.values())
            g = torch.ones(b, device=dev)
            ref = rl.rnnt_beta_grad(*fwd.values(), alpha, ll, g)
        with _plan_as("rnnt", route="warp"):
            ga, gll = rl.rnnt_alpha(*fwd.values())
            got = rl.rnnt_beta_grad(*fwd.values(), alpha, ll, g)
        live = alpha > -1e29
        require(torch.equal(live, ga > -1e29)
                and bool(((ga - alpha).abs() <= 1e-3 + 1e-5 * alpha.abs())[live].all())
                and bool(((gll - ll).abs() <= 1e-3 + 1e-5 * ll.abs()).all())
                and all(bool(((x - y).abs() <= 2e-3 * y.abs() + 1e-5).all())
                        for x, y in zip(got, ref)),
                f"the RNN-T lattice's warp route disagrees with its block route at B {b}, "
                f"T' {t}, U+1 {u1}")
        calls = {"rnnt_alpha": lambda: rl.rnnt_alpha(*fwd.values()),
                 "rnnt_beta_grad": lambda: rl.rnnt_beta_grad(*fwd.values(), alpha, ll, g)}
        rec = {}
        for name, call in calls.items():
            turns = {"block": [], "warp": []}
            for route in ("block", "warp", "warp", "block"):
                with _plan_as("rnnt", route=route):
                    turns[route].append(_time_ms(torch, call))
            rec[name] = dict(turns, plan=rl._rnnt_plan(u1, name.removeprefix("rnnt_"))["route"])
        out[f"b{b}_t{t}_u1_{u1}"] = rec
        print(f"rnnt lattice by route at U+1 {u1} (K {k}), B {b}, T' {t}, ms in turns "
              f"(block, warp, warp, block): " + "; ".join(
                  f"{name} {r['block'][0]:.4f} {r['warp'][0]:.4f} {r['warp'][1]:.4f} "
                  f"{r['block'][1]:.4f}, the plan's route {r['plan']}"
                  for name, r in rec.items()))
    return out


def _sm_ghz(torch) -> float:
    """The SM clock, GHz: a sleep kernel of SLEEP_CYCLES cycles timed by
    CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    torch.cuda.synchronize()
    return SLEEP_CYCLES / ev[0].elapsed_time(ev[1]) / 1e6


def _train_cfg(dtype: str, dropout: bool, fused_joint_loss: bool = True,
               fused_ffn: bool = False):
    """The flagship as bench.py trains it (bench.py:51-76): causal, static
    chunk 32, the rel-pos attention kernels, the fused joint loss (or with
    `fused_joint_loss=False` the materialized one), the fused FFN kernels with
    `fused_ffn` (bench.py's TPUASR_FUSED_FFN=1); with `dropout`, the JAX
    defaults (0.1) and dynamic chunks, else no dropout and the static
    chunk."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    cfg.model.fused_joint_loss = fused_joint_loss
    enc = cfg.model.encoder
    enc.causal, enc.static_chunk_size, enc.fused_attention = True, 32, True
    enc.fused_ffn = fused_ffn
    enc.use_dynamic_chunk = dropout
    if not dropout:
        enc.dropout_rate = enc.positional_dropout_rate = 0.0
        cfg.model.ctc_dropout_rate = 0.0
        cfg.model.predictor.dropout = 0.0
    return cfg


def _train_card_vs_cpu(torch, dev, fused_joint_loss: bool, fused_ffn: bool = False,
                       cfg=None, label: str = "") -> dict:
    """Phase 6a: one forward, backward and GuardedAdam step of the fp32
    flagship on the card and on the CPU, same weights and batch; 12a / 12b
    pass their own fp32 `cfg` (and its `label`)."""
    import numpy as np

    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.train import make_optimizer

    if cfg is None:
        cfg = _train_cfg("float32", dropout=False, fused_joint_loss=fused_joint_loss,
                         fused_ffn=fused_ffn)
        label = f"fused_joint_loss={fused_joint_loss}, fused_ffn={fused_ffn}"
    r = np.random.default_rng(SEED + 11)
    b, t, u = 2, 256, 16  # the shape of __graft_entry__.entry()
    host = (torch.from_numpy(r.standard_normal((b, t, 80)).astype(np.float32)),
            torch.tensor([t, 200], dtype=torch.int32),
            torch.from_numpy(r.integers(6, cfg.model.vocab_size, (b, u))),
            torch.tensor([u, 11], dtype=torch.int32))
    tx = make_optimizer(cfg.optim)
    res = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = init_weights(Transducer(cfg.model, device=device), SEED)
        model.train()
        out = model(*(x.to(device) for x in host))
        res[side] = _step_side(torch, model, tx, out)
    enc = cfg.model.encoder
    return _step_card_vs_cpu(
        torch, tx, res, f"fp32 training step ({label}), card vs CPU on [2, 256, 80] x 16 "
        f"tokens", f"fp32 sums in another order through {enc.num_blocks} blocks, the "
        "attention kernels' "
        "and the fused joint's 3xTF32 products, the lattice",
        rope=enc.attention_type == "rope", grouped=enc.encoder_type == "efficient_conformer")


def _step_side(torch, model, tx, out: dict) -> dict:
    """One side of a card-against-CPU training step: out["loss"]'s backward
    and a GuardedAdam step from fresh moments; -> the losses, the gradient
    norm, the gradients, the weights before and after, the Adam state (on
    the CPU) and the parameters' names."""
    out["loss"].backward()
    named = list(model.named_parameters())
    params = [p for _, p in named]
    p0 = [p.detach().cpu().clone() for p in params]
    grads = [p.grad.detach().clone() for p in params]
    gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    st = tx.update_guarded(grads, tx.init(params), params, torch.isfinite(gn), 1.0, gn)
    return {"losses": {k: float(v.detach()) for k, v in out.items()},
            "gn": float(gn), "grads": [g.cpu() for g in grads], "p0": p0,
            "p1": [p.detach().cpu() for p in params],
            "state": [None if x is None else x.cpu() for x in st], "names": [n for n, _ in named]}


def _step_card_vs_cpu(torch, tx, res: dict, what: str, why: str, rope: bool = False,
                      grouped: bool = False) -> dict:
    """Hold a training step's card side against its CPU side (`_step_side`
    each): losses and gradient norm within 1e-4 relative, every gradient
    leaf within 1e-3 of the leaf's max |g| (`why`: the reason), the key
    projections' biases (no gradient in exact arithmetic) within rounding
    noise, and the GuardedAdam step (`_adam_card_vs_cpu`)."""
    card, cpu = res["card"], res["cpu"]
    (lc, gc, grads_c), (lh, gh, grads_h) = ((x["losses"], x["gn"], x["grads"])
                                            for x in (card, cpu))
    require(all(torch.equal(x, y) for x, y in zip(card["p0"], cpu["p0"])),
            "the card's and the CPU's initial weights differ")
    names = cpu["names"]
    loss_ok = all(abs(lc[k] - lh[k]) <= 1e-4 * abs(lh[k]) + 1e-4 for k in lh)
    scale = max(float(g.abs().max()) for g in grads_h)
    # the key projection's bias gets no gradient in exact arithmetic (it adds
    # q.b_k to every score of a query: softmax is shift-invariant), so its
    # gradient is rounding noise on both sides; it is held to that instead
    # (the encoder's and the AED decoders' self- and cross-attention)
    # (RoPE rotates the key bias by the key's position: there it is a weight;
    # the efficient conformer's grouped attention zero-pads the last key
    # group, bias and all, so the bias is a weight in the blocks whose frames
    # do not fill whole groups and shift-free in the others: with `grouped`
    # each key bias is held as a leaf whose error may add the noise, 1e-6 of
    # the largest gradient entry)
    key_bias = [i for i, n in enumerate(names) if not rope
                and n.endswith(("self_attn.linear_k.bias", "src_attn.linear_k.bias"))]
    shift_free = [] if grouped else key_bias
    noise = max((max(float(grads_c[i].abs().max()), float(grads_h[i].abs().max()))
                 for i in shift_free), default=0.0)
    rels = [float((a - b_).abs().max() / b_.abs().max().clamp(min=1e-30))
            for a, b_ in zip(grads_c, grads_h)]
    if grouped:
        for i in key_bias:
            rels[i] = float((grads_c[i] - grads_h[i]).abs().max()
                            / (grads_h[i].abs().max() + 1e-3 * scale))
    held = [i for i in range(len(names)) if i not in shift_free]
    order = sorted(held, key=lambda i: -rels[i])
    worst = order[0]
    print(f"{what}: losses card {lc} cpu {lh} (tol 1e-4 relative); grad norm {gc:.6g} vs "
          f"{gh:.6g} (tol 1e-4 relative); gradient error / the leaf's max|g|, the three worst: "
          f"{[(names[i], f'{rels[i]:.3g}') for i in order[:3]]} (tol 1e-3: {why}); "
          f"the {len(shift_free)} key-projection biases (zero gradient in exact arithmetic) "
          f"reach {noise:.3g} against a largest gradient entry of {scale:.4g} (tol 1e-6 of "
          f"it: rounding noise)")
    require(loss_ok and abs(gc - gh) <= 1e-4 * gh, "card and CPU training losses differ")
    require(rels[worst] <= 1e-3, "card and CPU gradients differ")
    require(noise <= 1e-6 * scale, "a key-projection bias has more than rounding noise")
    adam = _adam_card_vs_cpu(torch, tx, card, cpu)
    return {"losses_card": lc, "losses_cpu": lh, "grad_norm_card": gc, "grad_norm_cpu": gh,
            "worst_grad_rel_err": rels[worst], **adam}


def _adam_card_vs_cpu(torch, tx, card: dict, cpu: dict) -> dict:
    """The GuardedAdam step of phase 6a, held two ways.

    1. The optimizer alone: the CPU's GuardedAdam on the card's own
       gradients, grad norm and initial weights must give the card's count,
       moments and weights. The same fp32 operations on the same inputs:
       mu and nu within 4 ulps (4 eps relative); nu_max and the weights'
       update within 1e-5 relative, because the bias correction 1 - b2**t
       cancels (one ulp of 0.98 is 3e-6 of 0.02, and powf may be off by
       two); the weights also within one ulp of their own, where p + update
       rounds.
    2. The step end to end, each side from its own gradients: the update
       p_after - p_before. A first Adam step moves an entry by
       -lr*warmup * u / (|u| + eps), u the clipped, decayed gradient
       (mu / (1 - b1) after a first step), so where u is not near zero the
       update is +-lr*warmup by u's sign. Not near zero: |u| at least ten
       times the largest card-vs-CPU difference of u in its leaf (so the
       two sides' u have one sign) and >= 1e-6 (100 x Adam's eps). There
       the two updates must agree within 1e-2 of a step plus one ulp of
       the weight, where p + update rounds, and no entry may move by the
       other sign. Near zero, any two first steps lie within two steps of
       each other."""
    c = tx.cfg
    step = c.lr * min(1.0, 1.0 / max(c.warmup_steps, 1))
    eps32 = torch.finfo(torch.float32).eps

    # 1. the optimizer alone, on the card's inputs
    ps = [p.clone() for p in card["p0"]]
    ref = tx.update_guarded(card["grads"], tx.init(ps), ps, torch.tensor(True), 1.0,
                            torch.tensor(card["gn"], dtype=torch.float32))
    count_c, mu_c, nu_c, nm_c = card["state"][:4]
    rel = lambda a, b_: float(((a - b_).abs() / b_.abs().clamp(min=1e-30)).max())
    m_err = {"mu": rel(mu_c, ref.mu), "nu": rel(nu_c, ref.nu)}
    if nm_c is not None:
        m_err["nu_max"] = rel(nm_c, ref.nu_max)
    p_bad = sum(int(((a - b_).abs() > eps32 * b_.abs() + 1e-5 * step).sum())
                for a, b_ in zip(card["p1"], ps))
    print(f"GuardedAdam alone (the CPU's on the card's gradients): count card "
          f"{int(count_c)} cpu {int(ref.count)}; moments' max relative error "
          f"{ {k: f'{v:.3g}' for k, v in m_err.items()} } (tol mu, nu 4 ulps = "
          f"{4 * eps32:.3g}, nu_max 1e-5: the bias correction cancels); weights off by "
          f"more than one ulp + 1e-5 of a step: {p_bad}")
    require(int(count_c) == int(ref.count) == 1, "the card's Adam count is not 1 after a "
                                                 "finite step, or differs from the CPU's")
    require(m_err["mu"] <= 4 * eps32 and m_err["nu"] <= 4 * eps32
            and m_err.get("nu_max", 0.0) <= 1e-5,
            "the card's Adam moments differ from the CPU's on the same inputs")
    require(p_bad == 0, "the card's Adam update differs from the CPU's on the same inputs")

    # 2. the step end to end, each side from its own gradients
    sizes = [p.numel() for p in cpu["p0"]]
    u_c, u_h = ((x["state"][1] / (1.0 - c.betas[0])).split(sizes) for x in (card, cpu))
    sure_n = near_n = flips_sure = flips_near = bad_sure = bad_near = 0
    worst = 0.0
    for p0, p1c, p1h, uc, uh in zip(cpu["p0"], card["p1"], cpu["p1"], u_c, u_h):
        dc, dh = (p1c - p0).double().reshape(-1), (p1h - p0).double().reshape(-1)
        ulp = eps32 * p1h.double().abs().reshape(-1)
        sure = uh.abs() >= max(10 * float((uc - uh).abs().max()), 1e-6)
        diff = (dc - dh).abs()
        flip = dc * dh < 0
        sure_n += int(sure.sum())
        near_n += int((~sure).sum())
        flips_sure += int((flip & sure).sum())
        flips_near += int((flip & ~sure).sum())
        bad_sure += int(((diff > 1e-2 * step + ulp) & sure).sum())
        bad_near += int(((diff > 2 * step + ulp) & ~sure).sum())
        if bool(sure.any()):
            worst = max(worst, float(((diff - ulp).clamp(min=0))[sure].max()) / step)
    print(f"GuardedAdam step end to end (step = lr*warmup = {step:.3g}): {sure_n} entries "
          f"with u not near zero: updates apart by more than 1e-2 step + 1 ulp: {bad_sure}, "
          f"worst excess {worst:.3g} step, other sign: {flips_sure} (tol 0); {near_n} near "
          f"zero: apart by more than 2 steps + 1 ulp: {bad_near}, other sign: {flips_near}")
    require(bad_sure == 0 and flips_sure == 0,
            "card and CPU updates differ where the gradient's sign is certain")
    require(bad_near == 0, "card and CPU updates differ by more than two steps")
    return {"adam_moment_rel_err": m_err, "adam_entries_sure": sure_n,
            "adam_entries_near_zero": near_n, "adam_sign_flips_sure": flips_sure,
            "adam_sign_flips_near_zero": flips_near, "adam_update_worst_excess_steps": worst}


def _train_bench(torch, dev, batch, fused_joint_loss: bool, n_steps: int = 10,
                 warmup: int = 2, fused_ffn: bool = False) -> tuple[dict, dict]:
    """Phases 6b/6c/6d: bench.py's configuration (6c: the materialized loss;
    6d: the fused FFN) on bench.py's batch through `make_train_step`, timed
    by `tools.batch_sweep.train_bench`, with every launch count set to 0
    just before; -> (stats, kernel launches during the steps)."""
    from tpuasr_torch.ops import reset_launch_counts
    from tpuasr_torch.tools.batch_sweep import train_bench

    cfg = _train_cfg("bfloat16", dropout=True, fused_joint_loss=fused_joint_loss,
                     fused_ffn=fused_ffn)
    cfg.feature.fbank_precision = "default"
    reset_launch_counts()
    r = train_bench(cfg, batch, dev, n_steps, warmup, SEED)
    for i, ok in enumerate(r.pop("finite")):
        require(ok, f"training step {i} was not finite")
    launches, state, own = r.pop("launches"), r.pop("state"), r.pop("port_kernels")
    require(launches["fbank_tc"] == warmup + n_steps and launches["fbank_fp32"] == 0
            and launches["fbank_fft"] == 0,
            f"{warmup + n_steps} steps launched fbank's tensor-core route "
            f"{launches['fbank_tc']} times, its dense fp32 route {launches['fbank_fp32']} times "
            f"and its FFT route {launches['fbank_fft']} times, not once a step and never")
    stats = dict(r, skipped=int(state.skipped), steps=state.step)
    stats["port_kernels_ms"] = {k: v[0] for k, v in own.items()}
    ms_sorted, losses, med = sorted(r["step_ms"]), r["losses"], r["step_ms_median"]
    busy, wall = r["profiled_step_device_busy_ms"], r["profiled_step_wall_ms"]
    route = "fused joint loss" if fused_joint_loss else "materialized loss (full logits)"
    route += ", fused FFN" if fused_ffn else ""
    print(f"bench.py's configuration, {route} (batch {BENCH_B} x {BENCH_FRAMES} frames, "
          f"{r['audio_seconds_per_step']:.2f} s of audio per step, bf16, dropout 0.1, dynamic "
          f"chunk, fused attention): losses {[round(x, 4) for x in losses]}; step ms median "
          f"{med:.1f} (min {ms_sorted[0]:.1f}, max {ms_sorted[-1]:.1f}, {n_steps} steps after "
          f"{warmup}); {r['audio_s_per_s']:.1f} audio-s/s; peak memory "
          f"{(r['max_memory_allocated'] or 0) / 2**30:.2f} GiB; profiled step: device busy "
          f"{busy:.2f} ms of {wall:.1f} ms wall ({100 * (1 - busy / wall):.0f}% idle), "
          f"{r['profiled_step_device_ops']} device operations")
    for key, count, ms in r["top_device_items"]:
        print(f"  {ms:8.3f} ms  {count:6d}x  {key[:90]}")
    # the port's own kernels in the step, by name (csrc/*.cu: anonymous
    # namespaces, names from the sources' prefixes)
    print("  the port's kernels in the step, ms: " + "; ".join(
        f"{k} {v[0]:.4f} ({v[1]}x)" for k, v in sorted(own.items(), key=lambda x: -x[1][0])))
    for name in ("fbank_pack_kernel", "fbank_tc_kernel"):
        require(own.get(name, [0, 0])[1] == 1, f"the profiled step ran {name} "
                                               f"{own.get(name, [0, 0])[1]} times, not once")
    require(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    require(int(state.skipped) == 0, "a training step was skipped")
    return stats, launches


def _lattice_route_ab(torch, dev, batch, kind) -> dict:
    """6b's training step's device busy ms with a lattice (`kind` "ctc" or
    "rnnt") by its block route and by its warp route (the plan fixed to
    each), one profiled step each (block, then warp: two turns of a route
    read within 0.1% of each other), after the training runs' launches
    are read; -> {route: [ms], "lattice_ms": {route: [the lattice kernels'
    own ms]}}."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.tools.profile_trace import profiled_step
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = _train_cfg("bfloat16", dropout=True)
    cfg.feature.fbank_precision = "default"
    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    tx = make_optimizer(cfg.optim)
    state, step = TrainState.create(model, tx), make_train_step(model, tx, cfg)
    busy, own = {"block": [], "warp": []}, {"block": [], "warp": []}
    for route in ("block", "warp"):
        with _plan_as(kind, route=route):
            state, ms, _, kern = profiled_step(step, state, batch, SEED)
        busy[route].append(ms)
        own[route].append(sum(e.self_device_time_total for e in kern
                              if re.search(LATTICES[kind][3], e.key)) / 1e3)
    mean = {k: sum(v) / len(v) for k, v in busy.items()}
    print(f"6b's step, device busy ms by {kind.upper()} lattice route (block, then warp): "
          f"block {busy['block']}, warp {busy['warp']}; means "
          f"{mean['block']:.3f} / {mean['warp']:.3f}, change "
          f"{mean['warp'] - mean['block']:+.3f} ms; the {kind.upper()} lattice kernels' own "
          f"ms: block {own['block']}, warp {own['warp']}")
    return dict(busy, lattice_ms=own)


def _compare_steps(base: dict, fused: dict) -> None:
    """Print 6d's step numbers beside 6b's (two calls of one script on one
    card; the host's spread between them is up to ~30% for the step)."""
    keys = (("step_ms_median", "step ms (median)"), ("audio_s_per_s", "audio-s/s"),
            ("profiled_step_device_busy_ms", "device busy ms"),
            ("profiled_step_device_ops", "device operations"),
            ("max_memory_allocated", "peak memory bytes"))
    print("6d (fused_ffn=True) beside 6b (fused_ffn=False): " + "; ".join(
        f"{label} {fused[k]:.6g} vs {base[k]:.6g}" for k, label in keys))


def _trainer(torch, save_dir: str) -> tuple[dict, dict, dict]:
    """Phase 8: `tpuasr_torch.tools.train` on the card, 2 epochs, then a
    resume from "latest" for a third; -> (stats, kernel launches over both
    runs, the kernels' recorded calls: `_recording`). It saves to
    `save_dir`, which phase 18 reads and the caller removes."""
    from tpuasr_torch.config import load_yaml
    from tpuasr_torch.data import synthetic_pipeline
    from tpuasr_torch.ops import LAUNCHES, reset_launch_counts
    from tpuasr_torch.tools.profile_trace import synced_ms
    from tpuasr_torch.tools.train import main as train_main
    from tpuasr_torch.train import latest_path, load_info

    dev = torch.device("cuda")  # the trainer's default
    with _recording(torch) as seen:
        sets = ["model.encoder.fused_ffn=True", "specaug.enabled=True", "data.synth_hard=True",
                "data.batch_size=12", "data.num_prefetch=2", f"train.save_dir={save_dir}",
                "train.log_dir=", "train.log_every=1"]
        reset_launch_counts()
        (first, ms_first) = synced_ms(dev, lambda: train_main(
            ["--workload", "online_rnnt", "--synthetic", "48", "--epochs", "2", "--set",
             *sets]))
        info = load_info(latest_path(save_dir))
        cfg = load_yaml(str(Path(save_dir) / "train.yaml"))
        require(cfg.model.encoder.fused_ffn and cfg.specaug.enabled and cfg.data.synth_hard
                and cfg.model.compute_dtype == "bfloat16" and cfg.model.fused_joint_loss,
                "the trainer's effective config is not the one asked for")
        require(info["epoch"] == 1 and info["step"] == first.state.step,
                f"the checkpoint after 2 epochs holds epoch {info['epoch']} step "
                f"{info['step']}, the run ended at step {first.state.step}")
        steps_e2 = synthetic_pipeline(cfg, 48, seed=0).steps_per_epoch(2)
        (second, ms_second) = synced_ms(dev, lambda: train_main(
            ["--workload", "online_rnnt", "--synthetic", "48", "--epochs", "3", "--resume",
             latest_path(save_dir)]))
        launches = dict(LAUNCHES)
        info3 = load_info(latest_path(save_dir))
    losses = first.train_losses + first.dev_losses + second.train_losses + second.dev_losses
    print(f"trainer: 2 epochs of {first.state.step // 2} steps ({ms_first / 1e3:.1f} s), "
          f"train losses {first.train_losses}, dev losses {first.dev_losses}; resumed at "
          f"epoch {info3['epoch']} from step {info['step']}: {len(second.train_losses)} epoch of "
          f"{second.state.step - info['step']} steps ({ms_second / 1e3:.1f} s, checkpoint "
          f"load and save included), train loss {second.train_losses}, dev loss "
          f"{second.dev_losses}, lr scale {second.state.lr_scale}")
    require(len(second.train_losses) == 1 and info3["epoch"] == 2,
            "the resumed run did not continue at the saved epoch")
    require(second.state.step == info["step"] + steps_e2,
            f"the resumed run ended at step {second.state.step}, not the saved "
            f"{info['step']} + {steps_e2}")
    require(all(math.isfinite(x) for x in losses), "a trainer loss is not finite")
    require(int(second.state.skipped) == 0, "a trainer step was skipped")
    return {"train_losses": first.train_losses + second.train_losses,
            "dev_losses": first.dev_losses + second.dev_losses,
            "steps": second.state.step, "first_run_s": ms_first / 1e3,
            "resumed_run_s": ms_second / 1e3}, launches, seen


# ---------------------------------------------------------------------------
# phase 9: a BZNSYP-layout corpus on disk through the port's CLIs
# ---------------------------------------------------------------------------

# 64 utterances, the first 48 train and the rest dev; 406 of the 409
# syllables, all of them in the train split, so the vocabulary is the
# flagship's 412 tokens
CORPUS_UTTS, CORPUS_TRAIN, CORPUS_SYLLABLES = 64, 48, 406
DECODE_MODES = ("rnnt_greedy", "ctc_greedy", "rnnt_beam", "ctc_prefix_beam", "rnnt_rescoring")


def _corpus_transcripts(np) -> list[list[str]]:
    """The corpus' syllable sequences, 8-12 a transcript: the train split
    holds every chosen syllable at least once, the dev split draws from
    them."""
    from tpuasr_torch.text import PINYIN_SYLLABLES

    rng = np.random.default_rng(SEED)
    syl = sorted(rng.choice(PINYIN_SYLLABLES, CORPUS_SYLLABLES, replace=False).tolist())
    lens = rng.integers(8, 13, size=CORPUS_UTTS)
    n_train = int(lens[:CORPUS_TRAIN].sum())
    require(n_train >= CORPUS_SYLLABLES, "the train split is too short to hold every syllable")
    seq = rng.permutation(syl).tolist() + rng.choice(syl, n_train - CORPUS_SYLLABLES).tolist()
    ends = np.cumsum(lens[:CORPUS_TRAIN])
    train = [seq[e - n:e] for e, n in zip(ends, lens[:CORPUS_TRAIN])]
    return train + [rng.choice(syl, n).tolist() for n in lens[CORPUS_TRAIN:]]


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _corpus(torch, card_name: str, root: str, card: str = "cuda",
            sets=()) -> tuple[dict, dict, dict]:
    """Phase 9: a BZNSYP-layout corpus written to disk, then the port's CLIs
    in this process through their `main(argv)`: split_data, gen_vocab, the
    trainer with --data_root for one epoch (the card's defaults and
    fused_ffn), evaluate in the five transducer modes and eval_streaming,
    each on the card and on the CPU in fp32, and decode_stream on one dev
    WAV on the card. `card` and `sets` (extra --set pairs for the trainer)
    let the phase be rehearsed at a cut size on a machine without a card.
    -> (stats, the run's kernel launches, {part: (its recorded card calls,
    its launches)} for its two parts, the trainer and serving). The
    corpus, the run's checkpoint and its outputs go under `root`, which
    phase 18 reads and the caller removes."""
    import contextlib
    import io

    import numpy as np

    from tpuasr_torch.config import load_yaml
    from tpuasr_torch.data.corpus import scan_split
    from tpuasr_torch.data.synthetic import write_bznsyp_corpus
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts
    from tpuasr_torch.tools import decode_stream, eval_streaming, evaluate, gen_vocab, split_data
    from tpuasr_torch.tools import train as train_tool
    from tpuasr_torch.tools.common import eval_config, eval_split

    on_card = [] if card == "cuda" else ["--device", card]
    sides = (("card", on_card), ("cpu", ["--device", "cpu"]))
    walls, deltas, out = {}, {}, {}

    def run(label, cli, argv):
        """One CLI call -> its result; its wall, its kernel launches and the
        head of its output are kept under `label`."""
        before = dict(LAUNCHES)
        recorded = lambda: {k: sum(c for c, _ in seen.get(k, {}).values()) for k in KERNELS}
        rec_before = recorded()
        buf = io.StringIO()
        _sync(torch)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.main(argv)
        _sync(torch)
        walls[label] = time.perf_counter() - t0
        deltas[label] = {k: LAUNCHES[k] - before[k] for k in KERNELS if LAUNCHES[k] > before[k]}
        rec = {k: n - rec_before[k] for k, n in recorded().items()}
        require(all(rec[k] == deltas[label].get(k, 0) for k in KERNELS),
                f"{label}: the wrappers' recorded launches {rec} are not its launches")
        head = [ln for ln in buf.getvalue().splitlines() if not ln.startswith("{")][:3]
        print(f"{label}: {walls[label]:.2f} s, launches {deltas[label]}; " + " | ".join(head))
        return res

    transcripts = _corpus_transcripts(np)
    text = write_bznsyp_corpus(root, transcripts, 48000, 24 * 512, seed=SEED)
    root24 = f"{root}/pcm24"  # the same corpus as 24-bit PCM, read natively
    _write_pcm24(np, f"{root}/Wave", f"{root24}/Wave")
    split, vocab, exp = f"{root}/split", f"{root}/vocab.txt", f"{root}/exp"
    data = [f"data.{s}_{k}={split}/{s}/{f}" for s in ("train", "dev", "test")
            for k, f in (("wav_scp", "wav.scp"), ("text", "pinyin"))]
    data.append(f"data.vocab_file={vocab}")
    ckpt = f"{exp}/latest"
    fp32 = ["--set", "model.compute_dtype=float32"]
    reset_launch_counts()
    parts = {}
    with _recording(torch) as seen:  # the corpus and the trainer
        counts = run("split_data", split_data, [
            "--transcript", text, "--out_dir", split, "--train_max", str(CORPUS_TRAIN),
            "--dev_max", str(CORPUS_UTTS)])
        require(counts == {"train": CORPUS_TRAIN, "dev": CORPUS_UTTS - CORPUS_TRAIN,
                           "test": 0}, f"split_data gave {counts}")
        n_vocab = run("gen_vocab", gen_vocab, [
            "--pinyin_files", *(f"{split}/{s}/pinyin" for s in ("train", "dev", "test")),
            "--out", vocab])
        require(n_vocab == CORPUS_SYLLABLES, f"gen_vocab wrote {n_vocab} syllables")
        trained = run("train", train_tool, [
            "--workload", "online_rnnt", "--data_root", root24, "--epochs", "1", "--set",
            "model.encoder.fused_ffn=True", f"train.save_dir={exp}", "train.log_dir=",
            *data, *sets, *on_card])
        cfg = load_yaml(f"{exp}/train.yaml")
        require(cfg.model.vocab_size == 412 and cfg.model.encoder.fused_ffn
                and (card != "cuda" or (cfg.model.compute_dtype == "bfloat16"
                                        and cfg.feature.fbank_precision == "default")),
                "the trainer's effective config is not the card's defaults with fused_ffn "
                "over 412 tokens")
        require(all(math.isfinite(x) for x in trained.train_losses + trained.dev_losses),
                "a loss of the trainer is not finite")
        out["train"] = {"steps": trained.state.step, "train_losses": trained.train_losses,
                        "dev_losses": trained.dev_losses, "corpus": "24-bit PCM"}
    parts["trainer"] = (seen, dict(LAUNCHES))
    out["pcm24"] = _pcm24_batches(np, cfg, root, root24)
    out["host_ms_per_batch"] = _host_read_ms(np, cfg, root, root24, card_name)
    with _recording(torch) as seen:  # serving from the checkpoint
        out["blank_logit_bias"] = _fit_corpus_blanks(torch, ckpt, root)

        evals, nbest = {}, {}
        for mode in DECODE_MODES:
            for side, dev in sides:
                with _nbest_capture() as got:
                    evals[mode, side] = run(f"evaluate {mode} {side}", evaluate, [
                        "--checkpoint", ckpt, "--workload", "online_rnnt", "--mode", mode,
                        "--data_root", root, "--max_samples", "16", *fp32, *dev])
                nbest[mode, side] = got.get(mode)
        pcm24 = {mode: run(f"evaluate {mode} card 24-bit", evaluate, [
            "--checkpoint", ckpt, "--workload", "online_rnnt", "--mode", mode,
            "--data_root", root24, "--max_samples", "16", *fp32, *on_card])
            for mode in DECODE_MODES[:2]}
        streams = {side: run(f"eval_streaming {side}", eval_streaming, [
            "--checkpoint", ckpt, "--data_root", root, "--max_samples", "16", *fp32, *dev])
            for side, dev in sides}
        # a dev WAV whose encoder frames are not a whole number of chunks
        chunk, hop = cfg.streaming.chunk_size, cfg.feature.hop_length
        tok, pipe = eval_split(eval_config(ckpt, None, [], torch.device("cpu")), "dev", 0,
                               1, root)
        metas = scan_split(cfg.data.dev_wav_scp, cfg.data.dev_text, tok, root)
        frames = lambda m: ((m.wave_len // hop) // 2 - 1) // 2  # ((T - 1)//2 - 1)//2
        utt = next(m for m in metas if frames(m) % chunk).utt_id
        lines = run("decode_stream card", decode_stream, [
            "--checkpoint", ckpt, "--wav", f"{root}/Wave/{utt}.wav", *fp32, *on_card])
    launches = dict(LAUNCHES)
    parts["serving"] = (seen, {k: n - parts["trainer"][1][k] for k, n in launches.items()})

    # card against CPU, outside the run's counts
    print(f"{card_name}: walls of the CLIs in this process (s, synced; evaluate over "
          f"{len(metas)} dev utterances): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                        walls.items()))
    out["walls_s"], out["launches_by_call"] = walls, deltas
    served = {k: v for k, v in deltas.items() if k.startswith(("evaluate", "eval_streaming",
                                                               "decode_stream"))}
    for name in ("fbank", "relpos_attention", "ffn_fwd"):
        require(sum(d.get(name, 0) for d in served.values()) > 0 or card != "cuda",
                f"serving from the checkpoint never launched {name}")
    require(deltas["evaluate rnnt_rescoring card"].get("rnnt_alpha", 0) > 0
            or card != "cuda", "evaluate --mode rnnt_rescoring never launched #8")
    valid = [int(b["num_valid"]) for b in pipe.batches(0)]
    out["agreement"] = _corpus_agreement(torch, evals, nbest, valid, tok)
    for mode, res in pcm24.items():
        ref = evals[mode, "card"]
        require(res.counts == ref.counts and res.samples == ref.samples,
                f"evaluate --mode {mode} on the card: the 24-bit corpus's hypotheses or "
                f"counts differ from the 16-bit corpus's")
        print(f"evaluate {mode} card, 24-bit corpus == 16-bit corpus on "
              f"{len(res.samples)} utterances, {vars(res.counts)}")
    out["pcm24"]["evaluate_identical"] = list(pcm24)
    same = [a[2] == b[2] for a, b in zip(streams["card"].samples, streams["cpu"].samples)]
    require(len(same) == len(metas) and all(same) and
            streams["card"].greedy == streams["cpu"].greedy,
            "eval_streaming's greedy hypotheses differ between the card and the CPU")
    beam_same = sum(a[3] == b[3] for a, b in zip(streams["card"].samples,
                                                 streams["cpu"].samples))
    print(f"eval_streaming card vs CPU: greedy hypotheses identical on {len(same)} "
          f"utterances ({streams['cpu'].greedy}); beam hypotheses identical on "
          f"{beam_same}; greedy CER {streams['card'].greedy.cer:.4f}, beam "
          f"{streams['card'].beam.cer:.4f}")
    out["streaming"] = {"greedy": vars(streams["card"].greedy),
                        "beam": vars(streams["card"].beam), "beam_same_as_cpu": beam_same}
    out["decode_stream"] = _decode_stream_check(
        torch, ckpt, f"{root}/Wave/{utt}.wav", lines, card,
        {s[0]: s for s in streams["card"].samples}[utt])
    out["cer"] = {f"{m} {s}": vars(r.counts) for (m, s), r in evals.items()}
    return out, launches, parts


def _write_pcm24(np, src: str, dst: str) -> None:
    """Every 16-bit WAV of `src` rewritten into `dst` as 24-bit PCM with
    samples v * 256 (the same values: v / 32768 == v * 256 / 8388608)."""
    import os
    import wave

    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        with wave.open(f"{src}/{name}", "rb") as r:
            require(r.getsampwidth() == 2, f"{name} is not 16-bit PCM")
            params, raw = r.getparams(), r.readframes(r.getnframes())
        pcm = np.zeros((len(raw) // 2, 3), np.uint8)
        pcm[:, 1:] = np.frombuffer(raw, np.uint8).reshape(-1, 2)  # little-endian v << 8
        with wave.open(f"{dst}/{name}", "wb") as w:
            w.setnchannels(params.nchannels)
            w.setsampwidth(3)
            w.setframerate(params.framerate)
            w.writeframes(pcm.tobytes())


def _pcm24_batches(np, cfg, root: str, root24: str) -> dict:
    """Every train and dev batch of the 24-bit copy (read by the native
    reader) against the 16-bit corpus's, bit for bit."""
    from tpuasr_torch.data import make_pipeline, scan_split
    from tpuasr_torch.tools.common import vocab_tokenizer

    tok, d, out = vocab_tokenizer(cfg, None), cfg.data, {}
    for split, scp, txt in (("train", d.train_wav_scp, d.train_text),
                            ("dev", d.dev_wav_scp, d.dev_text)):
        pipes = [make_pipeline(scan_split(scp, txt, tok, r), cfg) for r in (root, root24)]
        n = utts = 0
        for a, b in zip(*(p.batches(0) for p in pipes), strict=True):
            for k in a:
                same = np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) \
                    else a[k] == b[k]
                require(same, f"{split}: the 24-bit corpus's batch {n} differs from the "
                              f"16-bit corpus's in {k}")
            n, utts = n + 1, utts + int(a["num_valid"])
        out[split] = {"batches": n, "utterances": utts}
    print(f"the 24-bit corpus's batches (native reader) == the 16-bit corpus's, bit for bit: "
          f"{out}")
    return out


def _host_read_ms(np, cfg, root: str, root24: str, card_name: str, reps: int = 5) -> dict:
    """Host ms to read the trainer's batch (its first cfg.data.batch_size
    train utterances, files warm in the page cache) by `read_wav` (16-bit
    only), the native `wav_read` (16- and 24-bit) and `BatchLoader(8)`,
    the median of `reps` reads each. Recorded, no gate."""
    import statistics

    from tpuasr_torch.data import read_wav, scan_split
    from tpuasr_torch.tools.common import vocab_tokenizer
    from tpuasr_torch.utils.native import BatchLoader, wav_read

    d = cfg.data
    metas = scan_split(d.train_wav_scp, d.train_text, vocab_tokenizer(cfg, None),
                       root)[:d.batch_size]
    paths = {bits: [m.path if bits == 16 else m.path.replace(root, root24, 1) for m in metas]
             for bits in (16, 24)}
    longest = max(m.wave_len for m in metas)
    loader = BatchLoader(8)

    def median_ms(fn):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    try:
        out = {"utterances": len(metas), "samples": int(sum(m.wave_len for m in metas)),
               "read_wav_16bit": median_ms(lambda: [read_wav(p) for p in paths[16]]),
               **{f"native_wav_read_{b}bit": median_ms(
                   lambda b=b: [wav_read(p, m.wave_len) for p, m in zip(paths[b], metas)])
                  for b in (16, 24)},
               **{f"batch_loader_8_{b}bit": median_ms(
                   lambda b=b: loader.load(paths[b], longest)) for b in (16, 24)}}
    finally:
        loader.close()
    print(f"{card_name}: host ms to read the trainer's batch ({out['utterances']} WAVs, "
          f"{out['samples']} samples, warm files, median of {reps}): " + ", ".join(
              f"{k} {v:.3f}" for k, v in out.items() if k not in ("utterances", "samples")))
    return out


def _decode_stream_check(torch, ckpt, wav, lines, card, batch_hyp) -> dict:
    """decode_stream's output against the library on the same WAV on the
    card: its last greedy line is `streaming_greedy_decode`'s hypothesis of
    the WAV's own features gated at its true encoder length, and its cand 1
    `streaming_beam_decode`'s best; with no gate (every frame of the
    zero-padded last window decoded) the greedy hypothesis must extend the
    gated one, and what it adds are the trailing tokens the gate keeps out.
    eval_streaming's hypothesis of the utterance is printed beside them: it
    decodes the utterance inside its padded batch, whose frames past the
    utterance's end (fbank of zeros, -100 dB) differ from the zeros that
    pad decode_stream's last window, and the last chunk's valid frames
    attend to them, so the two may differ in the last chunk's tokens."""
    from tpuasr_torch.audio import fbank
    from tpuasr_torch.data import read_wav
    from tpuasr_torch.decode import streaming_beam_decode, streaming_greedy_decode
    from tpuasr_torch.decode.rnnt_streaming import init_streaming_state, process_chunk
    from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES
    from tpuasr_torch.streaming import chunk_windows, num_chunks
    from tpuasr_torch.tools.common import eval_config, restore_model, vocab_tokenizer

    dev = torch.device(card)
    cfg = eval_config(ckpt, None, ["model.compute_dtype=float32"], dev)
    tok = vocab_tokenizer(cfg, None)
    model = restore_model(cfg, "online_rnnt", dev, ckpt)
    wave, sr = read_wav(wav)
    cfg.feature.sample_rate = sr
    feats = fbank(torch.from_numpy(wave).to(dev), cfg.feature)[None]
    t = torch.tensor([feats.shape[1]])
    c, st = cfg.model, cfg.streaming
    text = lambda toks, n: " ".join(tok.decode(toks[: int(n)].tolist()))
    g, gl, _ = streaming_greedy_decode(model, feats, t, st.chunk_size, st.num_left_chunks,
                                       c.blank_id, st.n_steps)
    b, bl, _ = streaming_beam_decode(model, feats, t, st.chunk_size, st.num_left_chunks,
                                     c.blank_id, 4)
    sub = SUBSAMPLE_CLASSES[c.encoder.input_layer]
    n = num_chunks(feats.shape[1], st.chunk_size, sub.subsampling_rate, sub.right_context)
    state = init_streaming_state(model, 1, st.chunk_size, st.num_left_chunks, c.blank_id)
    for w in chunk_windows(feats, st.chunk_size, sub.subsampling_rate, sub.right_context, n):
        state = process_chunk(model, w, state, c.blank_id, st.n_steps)
    ungated = state.dec.hyp[0, : int(state.dec.hyp_len[0])]
    greedy = [ln.split(": ", 1)[1] for ln in lines if ln.startswith("chunk")]
    cand1 = next((ln.split("): ", 1)[1] for ln in lines if ln.startswith("cand 1 ")), None)
    gated = g[0, : int(gl[0])]
    trailing = len(ungated) - len(gated)
    print(f"decode_stream {wav.rsplit('/', 1)[-1]} ({feats.shape[1]} frames, {n} chunks, the "
          f"last window zero-padded): last greedy line {greedy[-1]!r}, "
          f"streaming_greedy_decode {text(g[0], gl[0])!r}; cand 1 {cand1!r}, "
          f"streaming_beam_decode {text(b[0], bl[0])!r}; without the gate {trailing} trailing "
          f"tokens more; eval_streaming in its batch: greedy {batch_hyp[2]!r}, beam "
          f"{batch_hyp[3]!r}")
    require(greedy[-1] == text(g[0], gl[0]), "decode_stream's last greedy line is not the "
                                             "streaming greedy decode of the WAV")
    require(cand1 == text(b[0], bl[0]), "decode_stream's cand 1 is not the streaming beam's best")
    require(trailing >= 0 and torch.equal(ungated[: len(gated)], gated),
            "the gated greedy hypothesis is not a prefix of the ungated one")
    return {"chunks": n, "trailing_tokens_without_gate": trailing,
            "same_as_eval_streaming": {"greedy": greedy[-1] == batch_hyp[2],
                                       "beam": cand1 == batch_hyp[3]}}


def _fit_corpus_blanks(torch, ckpt, root) -> dict:
    """Fit the checkpoint's blank logits (the joint's and the CTC head's) on
    the CPU in fp32, over the dev split, to the transcripts' tokens per
    encoder frame, as phases 4 and 4b fit the random model's (a model one
    epoch into its warm-up emits up to n_steps tokens a frame), and write
    them back into the checkpoint; -> the two biases."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.data import BatchSpec, make_batch
    from tpuasr_torch.data.corpus import _load, scan_split
    from tpuasr_torch.tools.common import eval_config, eval_split, restore_model
    from tpuasr_torch.train import (
        TrainState, load_info, make_optimizer, restore_checkpoint, save_checkpoint,
    )

    cpu = torch.device("cpu")
    cfg = eval_config(ckpt, None, [], cpu)
    tok = eval_split(cfg, "dev", 0, 1, root)[0]
    model = restore_model(cfg, "online_rnnt", cpu, ckpt)
    state = restore_checkpoint(ckpt, TrainState.create(model, make_optimizer(cfg.optim)))
    utts = [_load(m) for m in scan_split(cfg.data.dev_wav_scp, cfg.data.dev_text, tok, root)]
    b = make_batch(utts, BatchSpec(len(utts), max(u.wave_len for u in utts),
                                   max(len(u.tokens) for u in utts)))
    content = b["text_lens"] - 2  # <sos> and <eos>
    joint = _fit_blank_bias(torch, model, cfg, b["waves"], b["wave_lens"], content)
    with torch.no_grad():
        model.joint.ffn_out_bias[cfg.model.blank_id] = joint
    feats, flens = fbank_batch(b["waves"], b["wave_lens"], cfg.feature, device=cpu)
    enc, elens = model.encode(feats, flens)
    ctc = _fit_ctc_blank_bias(torch, model, enc, elens,
                              float(content.sum()) / float(elens.sum()))
    save_checkpoint(ckpt, state, load_info(ckpt))
    return {"joint": joint, "ctc": ctc}


@contextlib.contextmanager
def _nbest_capture():
    """While evaluate runs, keep the n-best (tokens, lens, scores) of each
    beam search make_offline_decoder calls, a batch each: -> {mode: [...]},
    filled as the run goes (`rnnt_rescoring`'s with the rescored scores)."""
    import tpuasr_torch.eval.cer_eval as ce

    got = {m: [] for m in DECODE_MODES[2:]}
    orig = {k: getattr(ce, k) for k in ("rnnt_beam_decode", "ctc_prefix_beam_search",
                                        "transducer_rescoring")}

    def beam(*a, **k):
        r = orig["rnnt_beam_decode"](*a, **k)
        got["rnnt_beam"].append(r[2:])
        return r

    def prefix(*a, **k):
        r = orig["ctc_prefix_beam_search"](*a, **k)
        got["ctc_prefix_beam"].append(r[2])
        return r

    def rescore(*a, **k):
        r = orig["transducer_rescoring"](*a, **k)
        got["rnnt_rescoring"].append((a[3], a[4], r[2]))
        return r

    ce.rnnt_beam_decode, ce.ctc_prefix_beam_search, ce.transducer_rescoring = beam, prefix, rescore
    try:
        yield got
    finally:
        for k, fn in orig.items():
            setattr(ce, k, fn)


def _corpus_agreement(torch, evals, nbest, valid, tok) -> dict:
    """evaluate's results on the card against the CPU's: rnnt_greedy and
    ctc_greedy the same hypotheses and S/D/I/N; each beam mode by PERF.md
    §2's rule on the n-best lists its searches gave on each side (`nbest`:
    {(mode, side): a triple a batch}, `valid`: each batch's valid rows; the
    CPU CLI's hypotheses must be the best of its own lists): the same best
    hypothesis on every utterance whose CPU margin exceeds 2d, at most 4 of
    16 inside it."""
    out = {}
    for mode in DECODE_MODES[:2]:
        a, b = evals[mode, "card"], evals[mode, "cpu"]
        require(a.counts == b.counts and a.samples == b.samples,
                f"evaluate --mode {mode}: the card's hypotheses or counts differ from the CPU's")
        print(f"evaluate {mode}: card == CPU on {len(a.samples)} utterances, {vars(a.counts)}")
        out[mode] = {"identical": True}
    for mode in DECODE_MODES[2:]:
        lists = {side: [tuple(x[:n] for x in t) for t, n in zip(nbest[mode, side], valid)]
                 for side in ("card", "cpu")}
        rec = _nbest_agreement(torch, f"evaluate {mode}", lists["card"], lists["cpu"])
        inside = {i for i, _ in rec["inside_2d"]}
        cpu_best = [" ".join(tok.decode(max(h, key=h.get)))
                    for t in lists["cpu"] for h in _hyps(*(x.cpu() for x in t))]
        a, b = evals[mode, "card"].samples, evals[mode, "cpu"].samples
        require([x[2] for x in b] == cpu_best, f"evaluate --mode {mode} on the CPU is not the "
                                               f"best of its own n-best search")
        differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        require(set(differ) <= inside, f"evaluate --mode {mode}: utterances {differ} differ "
                                       f"between the card and the CPU outside 2d")
        print(f"evaluate {mode}: card vs CPU hypotheses differ on {differ} (inside 2d: "
              f"{sorted(inside)})")
        out[mode] = dict(rec, differ=differ)
    return out


def _corpus_kernel_records(torch, parts) -> dict:
    """Phase 9's kernel records: each part of the run (the trainer, then
    serving from its checkpoint) held as phase 8's, the signature each part
    launched most timed (the trainer's only for a kernel serving did not
    launch); -> {kernel: the serving part's record where the kernel served,
    else the trainer's, with every signature of both parts under
    "shapes"}."""
    recs = {"serving": _trainer_kernel_records(torch, *parts["serving"], "corpus serving",
                                               timed=1)}
    recs["trainer"] = _trainer_kernel_records(torch, *parts["trainer"], "corpus trainer",
                                              timed=1, untimed=tuple(recs["serving"]))
    out = {}
    for name in WRAPPERS:
        have = [recs[p][name] for p in ("serving", "trainer") if name in recs[p]]
        out[name] = dict(have[0], shapes=[s for r in have for s in r["shapes"]])
    return out


# ---------------------------------------------------------------------------
# phase 8's kernel records: each kernel against its plain version on the
# inputs the trainer gave it
# ---------------------------------------------------------------------------

# the CTC loss's log-probs and labels, for F.ctc_loss on the CTC kernels' inputs
CTC_INPUTS = ("tpuasr_torch.losses.ctc", "lattice_inputs")


@contextlib.contextmanager
def _recording(torch, only=None):
    """While a run goes through the port, keep for each kernel (of `only`,
    or every one) the arguments of its wrapper's first call on the card
    that launched it at each signature (every tensor's type and shape, every other argument's value)
    and count the calls at each. Every attribute of a port module bound to
    a wrapper (or to CTC_INPUTS) is swapped for a recording one and restored
    on exit; -> {kernel: {signature: [calls, {argument: value}]}}, filled as
    the run goes."""
    import importlib
    import inspect

    from tpuasr_torch.ops import LAUNCHES

    seen = {}

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            if not any(isinstance(v, torch.Tensor) and v.is_cuda
                       for v in bound.arguments.values()):
                return fn(*args, **kwargs)  # a CPU call takes the plain version
            key = tuple((str(v.dtype), tuple(v.shape), v.device.type)
                        if isinstance(v, torch.Tensor) else v for v in bound.arguments.values())
            calls = seen.setdefault(name, {})
            args_in = None if key in calls else {
                k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                for k, v in bound.arguments.items()}
            before = LAUNCHES.get(name)
            out = fn(*args, **kwargs)
            if before is not None and LAUNCHES[name] == before:  # e.g. no rows: no launch
                idle = seen.setdefault("idle", {})
                idle[name] = idle.get(name, 0) + 1
                return out
            calls.setdefault(key, [0, args_in])[0] += 1
            return out

        return call

    targets = {name: (mod, fn) for name, (mod, fn, *_) in WRAPPERS.items()
               if only is None or name in only}
    if only is None:
        targets["ctc_inputs"] = CTC_INPUTS
    port = lambda: [m for name, m in list(sys.modules.items())
                    if name.split(".")[0] == "tpuasr_torch"]
    originals = {}  # id(recorder) -> (recorder, the wrapper it stands for)
    try:
        for name, (mod, attr) in targets.items():
            fn = getattr(importlib.import_module(mod), attr)
            rec = recorder(name, fn)
            originals[id(rec)] = (rec, fn)
            for m in port():
                for a, val in list(vars(m).items()):
                    if val is fn:
                        setattr(m, a, rec)
        yield seen
    finally:
        # also in modules first imported during the run, which bound a recorder
        for m in port():
            for a, val in list(vars(m).items()):
                entry = originals.get(id(val))
                if entry is not None and entry[0] is val:
                    setattr(m, a, entry[1])


def _trainer_kernel_records(torch, seen, launches, run: str = "trainer",
                            timed: int | None = None, untimed=()) -> dict:
    """Phase 8's (and 9's) kernel checks: every kernel the `run` launched,
    against its plain version on the arguments the run gave it at each
    signature (the buckets' shapes, training and dev pass, evaluation); the
    recorded calls must be the run's launches, no more and no fewer. With
    `timed` only the `timed` signatures launched most are timed, the others
    only held; kernels in `untimed` are only held. -> {kernel: the record at
    the signature launched most, with "shapes": every signature's}."""
    out = {}
    for name in WRAPPERS:
        calls = seen.get(name, {})
        if not calls and not launches[name]:
            continue  # a part of a run that never launches the kernel
        n = sum(c for c, _ in calls.values())
        require(n == launches[name], f"the {run} run launched {name} {launches[name]} times "
                                     f"but its wrapper was called {n} times")
        shapes = [dict(_hold(torch, name, args, f"{run}, {count} calls at",
                             seen.get("ctc_inputs"),
                             name not in untimed and (timed is None or i < timed)),
                       calls=count)
                  for i, (count, args) in enumerate(sorted(calls.values(),
                                                           key=lambda x: -x[0]))]
        out[name] = dict(shapes[0], shapes=[
            {k: s[k] for k in ("inputs", "calls", "max_abs_err", "tol", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")} for s in shapes])
    return out


# ---------------------------------------------------------------------------
# phase 10: the CTC workload and the trainer's options
# ---------------------------------------------------------------------------

def _ctc_cfg():
    """The CTC workload as the trainer builds it on the card: `CTCModel` at
    CTCModelConfig's defaults (conv2d8, d256, 8 heads, 3 blocks, FFN 1024,
    conv 31; fp32 whatever the compute type), 412 tokens, blank 5, fbank
    precision "default"."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.feature.fbank_precision = "default"
    return cfg


def _ctc_card_vs_cpu(torch, dev, bench) -> tuple[dict, dict]:
    """10a: one fp32 training step of the CTC model on the card and on the
    CPU from the same features (the card's fbank, kernel #1, at "default",
    copied to the CPU), no dropout; -> (the step's stats, {side: (log-probs,
    out_lens)} for 10c)."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.models import CTCModel, init_weights
    from tpuasr_torch.train import make_optimizer

    cfg = _ctc_cfg()
    with torch.no_grad():
        feats, feat_lens = fbank_batch(bench["waves"], bench["wave_lens"], cfg.feature,
                                       device=dev)
    host = (feats.cpu(), feat_lens.cpu(), bench["texts"].cpu(), bench["text_lens"].cpu())
    tx = make_optimizer(cfg.optim)
    res, lps = {}, {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = init_weights(CTCModel(cfg.ctc_model, cfg.model.vocab_size, cfg.model.blank_id,
                                      device), SEED)
        lp, out_lens, loss = model(*(x.to(device) for x in host))  # eval(): no dropout
        lps[side] = (lp.detach().cpu(), out_lens.cpu())
        res[side] = _step_side(torch, model, tx, {"loss": loss})
    require(torch.equal(*(x[1] for x in lps.values())), "card and CPU out_lens differ")
    err = float((lps["card"][0] - lps["cpu"][0]).abs().max())
    t, tp, c = feats.shape[1], lps["cpu"][0].shape[1], cfg.ctc_model
    print(f"CTCModel ({c.subsampling}, d{c.hidden_dim}, {c.attention_heads} heads, "
          f"{c.num_blocks} blocks, FFN {c.hidden_dim * c.ffn_factor}, conv {c.kernel_size}, "
          f"{cfg.model.vocab_size} tokens, fp32) on bench.py's batch: {BENCH_B} x {t} fbank frames -> {tp} encoder frames, labels "
          f"{bench['text_lens'].tolist()}; log-probs card vs CPU max |diff| {err:.3g}")
    stats = _step_card_vs_cpu(
        torch, tx, res, f"CTC training step card vs CPU on [{BENCH_B}, {t}, 80] features",
        "fp32 sums in another order through 3 blocks and three subsampling convs, the lattice")
    return dict(stats, log_prob_max_abs_diff=err, frames=t, encoder_frames=tp), lps


@contextlib.contextmanager
def _timed_steps(torch, step_home, step_attr: str):
    """While inside, each step made by the step factory `step_attr` of
    module `step_home` (what the trainer calls) is synced and timed; ->
    the list of (wall ms, audio seconds) a step, filled as the run goes."""
    from tpuasr_torch.tools.profile_trace import synced_ms

    walls, make = [], getattr(step_home, step_attr)

    def timed_step(model, tx, cfg, mesh=None):
        step = make(model, tx, cfg, mesh)

        def run(state, batch, seed):
            out, ms = synced_ms(batch["wave_lens"].device, lambda: step(state, batch, seed))
            walls.append((ms, float(batch["wave_lens"].sum()) / cfg.feature.sample_rate))
            return out

        return run

    setattr(step_home, step_attr, timed_step)
    try:
        yield walls
    finally:
        setattr(step_home, step_attr, make)


def _workload_trainer(torch, dev, workload: str, step_home, step_attr: str, cfg_ok) -> dict:
    """10b and 11b: `python -m tpuasr_torch.tools.train --workload <workload>`
    in this process at the card's defaults: the hard synthetic corpus as
    phase 8 cuts it (48 utterances, batch 12, prefetch depth 2, a
    6-utterance dev split), 2 epochs into a temporary directory under
    build/, then `--resume` for a third. Each step is synced and timed (its
    wall and its audio seconds: the step factory the trainer calls,
    `step_attr` of module `step_home`, is wrapped for the run); then one step
    of the resumed model, profiled, on the first training batch.
    `cfg_ok(cfg)` holds the saved effective config: -> None, or what is
    wrong with it."""
    import tempfile

    from tpuasr_torch.config import load_yaml
    from tpuasr_torch.data import synthetic_pipeline, tensors
    from tpuasr_torch.tools.profile_trace import profiled_step, synced_ms
    from tpuasr_torch.tools.train import main as train_main
    from tpuasr_torch.train import latest_path, load_info, make_optimizer

    make = getattr(step_home, step_attr)
    label = f"the {workload} trainer"

    (ROOT / "build").mkdir(exist_ok=True)
    with _timed_steps(torch, step_home, step_attr) as walls:
        with tempfile.TemporaryDirectory(prefix=f"{workload}-", dir=ROOT / "build") as save_dir:
            sets = ["data.synth_hard=True", "data.batch_size=12", "data.num_prefetch=2",
                    f"train.save_dir={save_dir}", "train.log_dir=", "train.log_every=1"]
            first, ms_first = synced_ms(dev, lambda: train_main(
                ["--workload", workload, "--synthetic", "48", "--epochs", "2", "--set", *sets]))
            info = load_info(latest_path(save_dir))
            cfg = load_yaml(str(Path(save_dir) / "train.yaml"))
            wrong = cfg_ok(cfg)
            require(wrong is None, f"{label}'s effective config: {wrong}")
            require(info["epoch"] == 1 and info["step"] == first.state.step,
                    f"the checkpoint after 2 epochs holds epoch {info['epoch']} step "
                    f"{info['step']}, the run ended at step {first.state.step}")
            steps_e2 = synthetic_pipeline(cfg, 48, seed=0).steps_per_epoch(2)
            n_first = len(walls)
            second, ms_second = synced_ms(dev, lambda: train_main(
                ["--workload", workload, "--synthetic", "48", "--epochs", "3", "--resume",
                 latest_path(save_dir)]))
            info3 = load_info(latest_path(save_dir))
    losses = first.train_losses + first.dev_losses + second.train_losses + second.dev_losses
    ms = sorted(w for w, _ in walls)
    med = ms[len(ms) // 2]
    audio = sorted(a for _, a in walls)[len(walls) // 2]
    batch = tensors(next(iter(synthetic_pipeline(cfg, 48, seed=0).batches(0))), dev)
    state, busy, wall, kern = profiled_step(
        make(second.state.model, make_optimizer(cfg.optim), cfg), second.state, batch, SEED)
    ops = sum(e.count for e in kern)
    print(f"{label}: 2 epochs of {first.state.step // 2} steps ({ms_first / 1e3:.1f} s), "
          f"train losses {first.train_losses}, dev losses {first.dev_losses}; resumed at epoch "
          f"{info3['epoch']} from step {info['step']}: {second.state.step - info['step']} steps "
          f"({ms_second / 1e3:.1f} s), train loss {second.train_losses}, dev loss "
          f"{second.dev_losses}; step wall (synced) median {med:.1f} ms (min {ms[0]:.1f}, max "
          f"{ms[-1]:.1f}, {len(ms)} steps), median {audio:.2f} s of audio a step, "
          f"{audio / med * 1e3:.1f} audio-s/s; one profiled step of batch "
          f"{list(batch['waves'].shape)}: device busy {busy:.2f} ms of {wall:.1f} ms wall "
          f"({100 * (1 - busy / wall):.0f}% idle), {ops} device operations")
    require(len(walls) - n_first == second.state.step - info["step"] == steps_e2,
            f"the resumed run of {label} did not take the saved epoch's steps")
    require(len(second.train_losses) == 1 and info3["epoch"] == 2,
            f"the resumed run of {label} did not continue at the saved epoch")
    require(all(math.isfinite(x) for x in losses), f"a loss of {label} is not finite")
    require(int(second.state.skipped) == 0, f"a step of {label} was skipped")
    return {"train_losses": first.train_losses + second.train_losses,
            "dev_losses": first.dev_losses + second.dev_losses, "steps": second.state.step,
            "first_run_s": ms_first / 1e3, "resumed_run_s": ms_second / 1e3,
            "step_ms": [w for w, _ in walls], "step_ms_median": med,
            "audio_seconds_per_step_median": audio, "audio_s_per_s": audio / med * 1e3,
            "profiled_step_device_busy_ms": busy, "profiled_step_wall_ms": wall,
            "profiled_step_device_operations": ops,
            "profiled_step_batch": list(batch["waves"].shape)}


def _ctc_trainer(torch, dev) -> dict:
    """10b: the CTC trainer (`_workload_trainer`; the trainer's
    `make_ctc_train_step` timed), at CTCModelConfig's defaults."""
    import tpuasr_torch.train as train_pkg

    def cfg_ok(cfg):
        if cfg.ctc_model != _ctc_cfg().ctc_model or cfg.feature.fbank_precision != "default":
            return "not CTCModelConfig's defaults with fbank \"default\""
        return None

    return _workload_trainer(torch, dev, "ctc", train_pkg, "make_ctc_train_step", cfg_ok)


def _ctc_decode_align(torch, dev, lps: dict, bench) -> dict:
    """10c: `ctc_greedy_decode` and `ctc_forced_align` (on the bench batch's
    labels) on the card and on the CPU, from the card's log-probs on both:
    tokens and alignments identical, Viterbi scores within 1e-6 relative;
    then each side from its own model's log-probs (printed)."""
    from tpuasr_torch.decode import ctc_forced_align, ctc_greedy_decode

    lp, lens = lps["card"]
    texts, tlens = bench["texts"].cpu(), bench["text_lens"].cpu()
    out = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        x, n = lp.to(device), lens.to(device)
        toks, tok_lens = ctc_greedy_decode(x, n, 5)
        align, scores = ctc_forced_align(x, texts.to(device), n, tlens.to(device), 5)
        out[side] = [t.cpu() for t in (toks, tok_lens, align, scores)]
    (tc, lc, ac, sc), (th, lh, ah, sh) = out["card"], out["cpu"]
    score_err = float(((sc - sh).abs() / sh.abs()).max())
    own = ctc_greedy_decode(*lps["cpu"], 5)
    same_own = sum(torch.equal(a[:m], b[:k]) for a, m, b, k in zip(tc, lc, own[0], own[1]))
    print(f"10c: ctc_greedy_decode on the card's log-probs, card vs CPU: tokens identical "
          f"{torch.equal(tc, th) and torch.equal(lc, lh)} ({int(lc.sum())} tokens); "
          f"ctc_forced_align: alignments identical {torch.equal(ac, ah)}, Viterbi scores "
          f"{[round(float(x), 3) for x in sc]}, max relative difference {score_err:.3g} (tol "
          f"1e-6); greedy hypotheses of each side's own model identical on {same_own} of "
          f"{len(lc)} utterances")
    require(torch.equal(tc, th) and torch.equal(lc, lh), "greedy CTC tokens differ")
    require(torch.equal(ac, ah), "forced alignments differ between the card and the CPU")
    require(score_err <= 1e-6, "forced-alignment scores differ")
    return {"greedy_tokens": int(lc.sum()), "align_score_max_rel_diff": score_err,
            "own_model_greedy_identical": same_own}


def _remat_check(torch, dev, bench) -> dict:
    """10d: the flagship at 6b's configuration (dropout 0.1, dynamic chunk,
    fused attention and joint loss; then also `fused_ffn=True`), in fp32 and
    in bf16 (6b's numerics): one training forward and backward with
    `encoder.gradient_checkpointing` off, on, and off again, on the same step
    generators. Loss within 1e-4 relative. Every gradient leaf within 1e-3
    of its max in fp32 (6a's tolerance), and within 2**-6 of it in bf16:
    there a leaf's gradient is made of bf16 values, #3 adds dp, du and dvb
    with fp32 atomics, and the rest of the backward can sum in another order
    between calls, so one bf16 step (2**-8 to 2**-7 of the largest entry)
    comes and goes between two flag-off runs as well (the two flag-off
    runs' own spread is printed beside); two steps are the repo's bf16
    gradient tolerance (tests/test_torch_cuda.py's attention backward and
    FFN). The key projections' biases, whose gradient is noise, within 1e-3
    of the largest entry. Each block's forward kernels (#2, and #10 with the
    fused FFN) launched twice with the flag and once without, and the flag's
    peak memory below the run without it."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.ops import LAUNCHES
    from tpuasr_torch.train.step import step_generators

    out = {}
    for dtype in ("float32", "bfloat16"):
        for ffn in (False, True):
            res = []
            for remat in (False, True, False):
                cfg = _train_cfg(dtype, dropout=True, fused_ffn=ffn)
                cfg.feature.fbank_precision = "default"
                cfg.model.encoder.gradient_checkpointing = remat
                model = init_weights(Transducer(cfg.model, device=dev), SEED)
                model.train()
                with torch.no_grad():
                    feats, feat_lens = fbank_batch(bench["waves"], bench["wave_lens"],
                                                   cfg.feature, device=dev)
                chunk_gen, drop_gen = step_generators(SEED, 0, dev)
                before = dict(LAUNCHES)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                loss = model(feats, feat_lens, bench["texts"], bench["text_lens"],
                             chunk_gen=chunk_gen, dropout_gen=drop_gen)["loss"]
                loss.backward()
                torch.cuda.synchronize()
                res.append({"loss": float(loss.detach()),
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "peak": torch.cuda.max_memory_allocated() - base,
                            "grads": [p.grad.float() for p in model.parameters()],
                            "names": [n for n, _ in model.named_parameters()],
                            "launches": {k: LAUNCHES[k] - before[k] for k in
                                         ("relpos_attention", "relpos_attention_bwd",
                                          "ffn_fwd", "ffn_bwd")}})
                del model, loss
            off, on, again = res
            names = off["names"]
            top = max(float(g.abs().max()) for g in off["grads"])
            # the key projections' biases get no gradient in exact arithmetic
            # (6a): theirs is noise, held against the model's largest entry
            shift_free = [i for i, n in enumerate(names) if n.endswith("self_attn.linear_k.bias")]
            tol = 1e-3 if dtype == "float32" else 2**-6

            def apart(x):  # -> (the key biases' |x - off|, {leaf: |x - off| / max|off|})
                diffs = [float((a - b).abs().max()) for a, b in zip(x["grads"], off["grads"])]
                return (max(diffs[i] for i in shift_free),
                        {i: diffs[i] / max(float(off["grads"][i].abs().max()), 1e-30)
                         for i in range(len(diffs)) if i not in shift_free})

            noise, rels = apart(on)
            _, spread = apart(again)
            worst, wide = max(rels, key=rels.get), max(spread, key=spread.get)
            tag = f"{dtype}, fused_ffn={ffn}"
            print(f"10d ({tag}): gradient checkpointing off / on: loss {off['loss']:.6f} / "
                  f"{on['loss']:.6f} (off again {again['loss']:.6f}); worst gradient leaf "
                  f"|on - off| / max|off| {rels[worst]:.3g} ({names[worst]}; tol {tol:.3g}); "
                  f"off again vs off {spread[wide]:.3g} ({names[wide]})"
                  f"; the key-projection biases' |on - off| {noise:.3g} against a "
                  f"largest gradient entry of {top:.4g} (tol 1e-3 of it); forward + backward "
                  f"{off['ms']:.1f} / {on['ms']:.1f} ms (synced); peak memory above the model "
                  f"and batch {off['peak'] / 2**30:.3f} / {on['peak'] / 2**30:.3f} GiB; "
                  f"launches {off['launches']} / {on['launches']}")
            require(abs(on["loss"] - off["loss"]) <= 1e-4 * abs(off["loss"]),
                    f"the loss changes with gradient checkpointing ({tag})")
            require(rels[worst] <= tol and noise <= 1e-3 * top,
                    f"gradient checkpointing changes the gradients ({tag})")
            require(on["peak"] < off["peak"], f"gradient checkpointing did not lower the peak "
                                              f"memory ({tag})")
            kernels = ("relpos_attention", "ffn_fwd") if ffn else ("relpos_attention",)
            for k in kernels:
                require(on["launches"][k] == 2 * off["launches"][k] > 0,
                        f"with gradient checkpointing {k} launched {on['launches'][k]} times, "
                        f"not twice the {off['launches'][k]} without ({tag})")
            out[tag] = {"loss_off": off["loss"], "loss_on": on["loss"],
                        "worst_grad_rel_diff": rels[worst], "tol": tol,
                        "worst_grad_rel_diff_off_again": spread[wide],
                        "key_bias_grad_diff": noise, "ms_off": off["ms"], "ms_on": on["ms"],
                        "peak_bytes_off": off["peak"], "peak_bytes_on": on["peak"],
                        "launches_off": off["launches"], "launches_on": on["launches"]}
    return out


def _accum_check(torch, dev, bench) -> dict:
    """10e: four steps of `make_train_step` at 6b's configuration with
    `optim.accum_steps=2` and attention dropout 0.1 (so the attention takes
    the plain route, #2/#3 never launch): every loss finite, the weights
    unchanged after each odd micro-step and changed after each even one,
    the Adam count 2 at the end."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.ops import LAUNCHES
    from tpuasr_torch.tools.profile_trace import synced_ms
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = _train_cfg("bfloat16", dropout=True)
    cfg.feature.fbank_precision = "default"
    cfg.optim.accum_steps = 2
    cfg.model.encoder.attention_dropout_rate = 0.1
    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    tx = make_optimizer(cfg.optim)
    state, step = TrainState.create(model, tx), make_train_step(model, tx, cfg)
    snap = lambda: torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    before, prev = dict(LAUNCHES), snap()
    losses, ms, moved = [], [], []
    for i in range(4):
        (state, metrics), dt = synced_ms(dev, lambda: step(state, bench, SEED))
        losses.append(float(metrics["loss"]))
        ms.append(dt)
        now = snap()
        moved.append(not torch.equal(now, prev))
        prev = now
    launches = {k: LAUNCHES[k] - before[k] for k in ("relpos_attention", "relpos_attention_bwd",
                                                     "rnnt_fused_fwd", "ctc_alpha")}
    print(f"10e: accum_steps=2, attention dropout 0.1: losses {[round(x, 4) for x in losses]}, "
          f"step ms {[round(x, 1) for x in ms]}; weights moved after micro-steps "
          f"{[i + 1 for i, m in enumerate(moved) if m]}; Adam count "
          f"{int(state.opt_state.count)}; launches {launches}")
    require(all(math.isfinite(x) for x in losses), "an accumulated step's loss is not finite")
    require(moved == [False, True, False, True], "the weights did not move on the even "
                                                 "micro-steps alone")
    require(int(state.opt_state.count) == 2 and int(state.opt_state.mini_step) == 0,
            "the Adam count is not 2 after two cycles")
    require(launches["relpos_attention"] == launches["relpos_attention_bwd"] == 0,
            "attention dropout did not take the plain attention route")
    return {"losses": losses, "step_ms": ms, "moved": moved, "launches": launches}


# ---------------------------------------------------------------------------
# phase 11: the AED workload
# ---------------------------------------------------------------------------

AED_B, AED_BEAM, AED_MAX_TOKENS = 4, 4, 24
AED_MODES = ("ctc_greedy", "ctc_prefix_beam", "attention", "attention_rescoring")


def _aed_cfg(dropout: bool = True, r_blocks: int = 0):
    """The AED workload at the repo's own defaults, as the trainer builds it
    on the card: `ASRModel` over the non-causal rel-pos conformer of
    EncoderConfig's defaults (12 blocks, d256, 4 heads, FFN 1024, conv 31,
    conv2d subsampling) with `fused_attention`, a 6-block decoder (4 heads,
    FFN 1024; with `r_blocks` an R2L decoder of that many blocks, reverse
    weight 0.3), 412 tokens, blank 5, sos 2, eos 3, ctc_weight 0.3,
    lsm_weight 0.1; fp32, fbank precision "default"; without `dropout`
    every dropout rate 0."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.encoder.fused_attention = True
    cfg.feature.fbank_precision = "default"
    cfg.model.att_decoder.r_blocks = r_blocks
    if not dropout:
        cfg.model.encoder.dropout_rate = cfg.model.encoder.positional_dropout_rate = 0.0
    return cfg


def _aed_model(cfg, device):
    """The trainer's own build (`tools.train.build_model`, seed train.seed)."""
    from tpuasr_torch.tools.train import build_model

    return build_model(cfg, "aed", device)


def _aed_card_vs_cpu(torch, dev, bench) -> dict:
    """11a: one fp32 training step of the AED model on the card and on the
    CPU from the same features (the card's fbank at "default" on the first
    AED_B waves of bench.py's batch, copied), no dropout: the losses, every
    gradient leaf and the GuardedAdam step held as 6a holds them; the
    teacher-forced accuracy within one token (an argmax on a near tie may
    flip)."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.train import make_optimizer

    cfg = _aed_cfg(dropout=False)
    with torch.no_grad():
        feats, feat_lens = fbank_batch(bench["waves"][:AED_B], bench["wave_lens"][:AED_B],
                                       cfg.feature, device=dev)
    host = (feats.cpu(), feat_lens.cpu(), bench["texts"][:AED_B].cpu(),
            bench["text_lens"][:AED_B].cpu())
    tx = make_optimizer(cfg.optim)
    res, acc = {}, {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = _aed_model(cfg, device).train()  # no dropout rate: no generator needed
        out = model(*(x.to(device) for x in host))
        acc[side] = float(out.pop("th_accuracy"))
        res[side] = _step_side(torch, model, tx, out)
    n_tok = int(host[3].sum()) + AED_B  # the targets and their <eos>
    t = feats.shape[1]
    stats = _step_card_vs_cpu(
        torch, tx, res, f"AED training step (fp32, fused_attention) card vs CPU on "
        f"[{AED_B}, {t}, 80] features x labels {host[3].tolist()}",
        "fp32 sums in another order through 12 encoder and 6 decoder blocks, the attention "
        "kernels' 3xTF32 products, the CTC lattice")
    print(f"11a: th_accuracy card {acc['card']:.6f} CPU {acc['cpu']:.6f} over {n_tok} "
          f"teacher-forced tokens (tol one token, {1 / n_tok:.4f})")
    require(abs(acc["card"] - acc["cpu"]) <= 1 / n_tok + 1e-6, "th_accuracy differs")
    return dict(stats, th_accuracy_card=acc["card"], th_accuracy_cpu=acc["cpu"], frames=t)


def _aed_trainer(torch, dev) -> dict:
    """11b: the AED trainer (`_workload_trainer`; the loop's
    `make_train_step` timed), at the card's defaults (bf16,
    `fused_attention`, fbank "default") and model.att_decoder's."""
    import tpuasr_torch.train.loop as loop

    def cfg_ok(cfg):
        m = cfg.model
        if not (m.compute_dtype == "bfloat16" and m.encoder.fused_attention
                and cfg.feature.fbank_precision == "default"
                and m.att_decoder == _aed_cfg().model.att_decoder):
            return "not the card's defaults"
        return None

    return _workload_trainer(torch, dev, "aed", loop, "make_train_step", cfg_ok)


def _fit_eos_bias(torch, model, enc, elens, target: float) -> tuple[float, float]:
    """Set the attention decoder's <eos> logit (bisection on [-16, 16]) so
    that attention beam search's best hypotheses average `target` tokens;
    -> (the bias, the mean length it gives). With random weights the search
    otherwise ends at once or never."""
    from tpuasr_torch.decode import attention_beam_search

    bias = model.decoder.output_layer.bias
    c = model.cfg

    def mean_len(b: float) -> float:
        with torch.no_grad():
            bias[c.eos_id] = b
        lens = attention_beam_search(model, enc, elens, c.sos_id, c.eos_id, AED_BEAM,
                                     AED_MAX_TOKENS)[1]
        return float(lens.float().mean())

    free = mean_len(0.0)
    lo, hi = -16.0, 16.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if mean_len(mid) > target else (lo, mid)
    got = mean_len(hi)
    print(f"<eos> logit bias {hi:.4f}: attention beam search's best hypotheses average "
          f"{got:.2f} tokens (target {target:.1f}, max_tokens {AED_MAX_TOKENS}); {free:.2f} "
          f"with no bias")
    return hi, got


def _aed_searches(torch, model, enc, elens) -> dict:
    """Every AED mode's search on one side's encoder output -> {mode:
    (n-best tokens, lens, scores), or (tokens, lens) for ctc_greedy}."""
    from tpuasr_torch.decode import (
        attention_beam_search, ctc_greedy_decode, ctc_prefix_beam_search,
    )
    from tpuasr_torch.decode.dispatch import rescoring_inputs
    from tpuasr_torch.models import attention_rescoring

    c = model.cfg
    lp = torch.log_softmax(model.ctc_logits(enc).float(), dim=-1)
    nb = ctc_prefix_beam_search(lp, elens, c.blank_id, AED_BEAM, AED_MAX_TOKENS)[2]
    att = attention_beam_search(model, enc, elens, c.sos_id, c.eos_id, AED_BEAM,
                                AED_MAX_TOKENS, nbest=True)
    r_enc, r_lens, rw = rescoring_inputs(model, lp, enc, elens)
    return {"ctc_greedy": ctc_greedy_decode(lp, elens, c.blank_id), "ctc_prefix_beam": nb,
            "attention": att[3] + (att[2],),
            "attention_rescoring": nb[:2] + (attention_rescoring(
                model, r_enc, r_lens, *nb, 0.5, reverse_weight=rw)[2],)}


def _aed_decode(torch, dev, data) -> dict:
    """11c: the four AED modes of `make_offline_decoder` on the fixture
    requests, fp32 (fbank "default", as a checkpoint trained on the card
    keeps it), card against CPU: the CTC head's blank logit fitted as phase
    4b fits it, the decoder's <eos> logit so that the attention beam's best
    hypotheses average half of AED_MAX_TOKENS; ctc_greedy tokens identical,
    each beam mode by phase 4b's 2d rule on its n-best lists;
    `make_offline_decoder` in each mode gives its search's best on the card;
    each mode's synced latency after a warm-up call; the attention mode's
    decoder steps and device busy ms over one call. Then the model with an
    R2L decoder (3 blocks, reverse weight 0.3) through attention_rescoring,
    card against CPU by the same rule."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode.rnnt_beam import first_argmax
    from tpuasr_torch.eval import make_offline_decoder
    from tpuasr_torch.tools.profile_trace import synced_ms

    waves, wave_lens = data["fixture"]
    out = {}
    for r_blocks in (0, 3):
        label = "r2l" if r_blocks else "l2r"
        cfg = _aed_cfg(r_blocks=r_blocks)
        models = {"card": _aed_model(cfg, dev), "cpu": _aed_model(cfg, torch.device("cpu"))}
        enc = {}
        for side, model in models.items():
            feats, flens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
            enc[side] = model.encode(feats, flens)
        c = models["card"].cfg
        target = float(data["text_lens"].sum()) / float(enc["cpu"][1].sum())
        rec = {"ctc_blank_logit_bias": _fit_ctc_blank_bias(torch, models["card"],
                                                           *enc["card"], target)}
        eos, rec["attention_mean_len"] = _fit_eos_bias(torch, models["card"], *enc["card"],
                                                       AED_MAX_TOKENS / 2)
        rec["eos_logit_bias"] = eos
        require(AED_MAX_TOKENS / 4 <= rec["attention_mean_len"] <= 3 * AED_MAX_TOKENS / 4,
                f"{label}: the attention hypotheses average {rec['attention_mean_len']:.2f} "
                f"tokens, outside a quarter to three quarters of {AED_MAX_TOKENS}")
        with torch.no_grad():
            models["cpu"].ctc_lo.bias[c.blank_id] = rec["ctc_blank_logit_bias"]
            models["cpu"].decoder.output_layer.bias[c.eos_id] = eos
        found = {side: _aed_searches(torch, m, *enc[side]) for side, m in models.items()}
        card, cpu = found["card"], found["cpu"]
        modes = AED_MODES if not r_blocks else ("attention_rescoring",)
        if "ctc_greedy" in modes:
            same = all(torch.equal(a.cpu(), b) for a, b in zip(card["ctc_greedy"],
                                                               cpu["ctc_greedy"]))
            print(f"{label} ctc_greedy card vs CPU on {len(wave_lens)} requests: tokens "
                  f"identical {same} (emitted {int(cpu['ctc_greedy'][1].sum())})")
            require(same, "AED ctc_greedy tokens on the card differ from the CPU run")
        rec["agreement"] = {m: _nbest_agreement(torch, f"{label} {m}", card[m], cpu[m])
                            for m in modes if m != "ctc_greedy"}
        # the entry point: make_offline_decoder on the card gives the search's best
        lat = {}
        for mode in modes:
            dec = make_offline_decoder(models["card"], cfg, mode, beam_size=AED_BEAM,
                                       max_tokens=AED_MAX_TOKENS)
            toks, lens = dec(waves, wave_lens)
            if mode == "ctc_greedy":
                ref_t, ref_l = card[mode]
            else:
                nb_t, nb_l, nb_s = card[mode]
                rows = torch.arange(nb_t.shape[0], device=dev)
                pick = first_argmax(nb_s, 1)
                ref_t, ref_l = nb_t[rows, pick], nb_l[rows, pick]
            require(torch.equal(toks, ref_t) and torch.equal(lens, ref_l),
                    f"make_offline_decoder({mode!r}) differs from its search on the card")
            lat[mode] = synced_ms(dev, lambda: dec(waves, wave_lens))[1]
            print(f"  {label} {mode}: {lat[mode]:.1f} ms for the {len(wave_lens)} fixture "
                  f"requests (fp32, synced, after a warm-up call); best hypotheses "
                  f"{int(lens.sum())} tokens")
        rec["latency_ms"] = lat
        if not r_blocks:
            # the attention search's steps, and the device's share of its call
            card_model, steps = models["card"], []
            one = card_model.decoder_one_step
            card_model.decoder_one_step = lambda *a: steps.append(1) or one(*a)
            try:
                busy, kern = _decode_busy(torch, make_offline_decoder(
                    card_model, cfg, "attention", beam_size=AED_BEAM,
                    max_tokens=AED_MAX_TOKENS), waves, wave_lens)
            finally:
                del card_model.decoder_one_step
            ops = sum(e.count for e in kern)
            print(f"  {label} attention: {len(steps)} decoder steps, device busy {busy:.2f} ms "
                  f"(profiler) in {ops} device operations, {ops / max(len(steps), 1):.0f} a "
                  f"step with the encoder's")
            rec["attention_profile"] = {"decoder_steps": len(steps), "device_busy_ms": busy,
                                        "device_operations": ops}
        out[label] = rec
    return out


# ---------------------------------------------------------------------------
# phase 12: the transducer's other model options
# ---------------------------------------------------------------------------

ZOO = {
    # 12a, icefall-style: the stateless embedding predictor (history 2, 4
    # heads, embed = output = 256) and the pruned loss over 5 label positions
    "stateless_pruned": {"model.predictor.predictor_type": "embedding",
                         "model.rnnt_prune_range": 5, "model.encoder.num_blocks": CUT_BLOCKS},
    # 12b: RoPE with 2 K/V heads, no positional table, MoE FFNs (8 experts, 2
    # active), RMS-normed conv modules, the conv predictor and a HAT joint
    "zoo": {"model.encoder.attention_type": "rope", "model.encoder.n_kv_head": 2,
            "model.encoder.pos_enc_layer_type": "no_pos", "model.encoder.mlp_type": "moe",
            "model.encoder.n_expert": 8, "model.encoder.n_expert_activated": 2,
            "model.encoder.cnn_module_norm": "rms_norm", "model.predictor.predictor_type": "conv",
            "model.joint.hat_joint": True, "model.encoder.num_blocks": CUT_BLOCKS},
    # 12c, full context: FireRed's front end and attention, gated FFNs, batch
    # norm (evaluation, seeded running statistics) and a post-join linear
    "full_context": {"model.encoder.encoder_type": "firered", "model.encoder.mlp_type": "gated",
                     "model.encoder.cnn_module_norm": "batch_norm",
                     "model.joint.postjoin_linear": True, "model.encoder.num_blocks": CUT_BLOCKS},
}


def _zoo(cfg, name: str):
    """`cfg` with phase 12's configuration `name` set on it (ZOO), or phase
    13's (FAMILIES)."""
    from tpuasr_torch.config import override

    return override(cfg, ZOO[name] if name in ZOO else FAMILIES[name])


def _zoo_models(torch, dev, name: str, data) -> dict:
    """The fp32 flagship (`_flagship`; 12a with the fused FFN) with ZOO[name]
    (or phase 13's FAMILIES[name]), seed-0 weights on the
    card and the CPU (batch norms' running statistics drawn from a seeded
    numpy generator: mean N(0, 0.3), variance U(0.5, 2)), the joint's blank
    logit and the CTC head's fitted on the card (`_fit_blank_bias`,
    `_fit_ctc_blank_bias`) and copied to the CPU; each side's encoder output
    from the card's features of the fixture requests (shared: a 1e-5 dB
    fbank difference moves a dB value near a first-conv ReLU's edge, and
    MoE routing and RoPE carry it further than phase 4's encoder)."""
    import numpy as np

    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.models import Transducer, init_weights

    cfg = _zoo(_flagship("float32", fused_ffn=name == "stateless_pruned"), name)
    card = init_weights(Transducer(cfg.model, device=dev), SEED)
    r = np.random.default_rng(SEED + 12)
    with torch.no_grad():
        for key, buf in card.named_buffers():
            if key.endswith(".mean"):
                buf.copy_(torch.from_numpy(r.normal(0.0, 0.3, buf.shape).astype(np.float32)))
            elif key.endswith(".var"):
                buf.copy_(torch.from_numpy(r.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    waves, wave_lens = data["fixture"]
    bias = _fit_blank_bias(torch, card, cfg, waves, wave_lens, data["text_lens"])
    feats, flens = fbank_batch(waves, wave_lens, cfg.feature, device=dev)
    enc = {"card": card.encode(feats, flens)}
    target = float(data["text_lens"].sum()) / float(enc["card"][1].sum())
    ctc_bias = _fit_ctc_blank_bias(torch, card, *enc["card"], target)
    cpu = Transducer(cfg.model, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    enc["cpu"] = cpu.encode(feats.cpu(), flens.cpu())
    err = float((enc["card"][0].cpu() - enc["cpu"][0]).abs().max())
    print(f"{name}: fp32 encoder card vs CPU on the card's features of the {len(wave_lens)} "
          f"fixture requests: max_abs_err {err:.3g} (tol 2e-3, as phase 4)")
    require(err <= 2e-3, f"{name}: card and CPU encoder outputs differ")
    return {"cfg": cfg, "card": card, "cpu": cpu, "enc": enc, "blank_logit_bias": bias,
            "ctc_blank_logit_bias": ctc_bias, "encoder_max_abs_err": err}


def _zoo_serve(torch, dev, data, m, modes, streaming: bool, stream_beam: bool = False) -> dict:
    """12a-12c's and 13c's serving, fp32, card against CPU on the fixture
    requests (each side's search on its encoder output of `_zoo_models`):
    greedy tokens identical, `make_offline_decoder`'s on the card its
    search's, the beam modes of `modes` (rnnt_beam beam 4, ctc_prefix_beam
    beam 4, rnnt_rescoring of the CTC prefix beam's n-best) by phase 4b's 2d
    rule; with `streaming`, streaming greedy == chunk-masked offline greedy
    on the card, as phase 5 holds it, at the configuration's chunk and left
    chunks over the frames whole chunks cover (at the encoder's output rate:
    the efficient conformer's chunk emits chunk / 2 frames), and with
    `stream_beam` streaming beam == chunk-masked offline beam, as phase 5b
    holds it."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import (
        ctc_prefix_beam_search, rnnt_beam_decode, rnnt_greedy_decode, streaming_beam_decode,
        streaming_greedy_decode, transducer_rescoring,
    )
    from tpuasr_torch.eval import make_offline_decoder
    from tpuasr_torch.models.transducer import stream_output_factor
    from tpuasr_torch.nn.subsampling import subsampled_len
    from tpuasr_torch.streaming import num_chunks
    from tpuasr_torch.tools.profile_trace import synced_ms

    cfg, c = m["cfg"], m["cfg"].model
    waves, wave_lens = data["fixture"]
    toks = {side: rnnt_greedy_decode(m[side], *m["enc"][side], c.blank_id)
            for side in ("card", "cpu")}
    same = all(torch.equal(a.cpu(), b) for a, b in zip(toks["card"], toks["cpu"]))
    dec = make_offline_decoder(m["card"], cfg, "rnnt_greedy")
    entry, ms = synced_ms(dev, lambda: dec(waves, wave_lens))
    print(f"rnnt_greedy card vs CPU: tokens identical {same} (emitted "
          f"{int(toks['cpu'][1].sum())}); make_offline_decoder on the card {ms:.1f} ms for the "
          f"{len(wave_lens)} requests")
    require(same, "rnnt_greedy tokens on the card differ from the CPU run")
    require(all(torch.equal(a, b) for a, b in zip(entry, toks["card"])),
            "make_offline_decoder('rnnt_greedy') differs from its search on the card")
    out = {"rnnt_greedy_identical": same, "rnnt_greedy_ms": ms,
           "rnnt_greedy_tokens": int(toks["cpu"][1].sum()), "agreement": {}}

    def searches(model, e, el):
        found = {}
        if "rnnt_beam" in modes:
            found["rnnt_beam"] = rnnt_beam_decode(model, e, el, c.blank_id, 4, 200)[2:]
        if "rnnt_rescoring" in modes or "ctc_prefix_beam" in modes:
            lp = torch.log_softmax(model.ctc_logits(e).float(), dim=-1)
            nb = ctc_prefix_beam_search(lp, el, c.blank_id, 4, 200)[2]
            found["ctc_prefix_beam"] = nb
            found["rnnt_rescoring"] = nb[:2] + (transducer_rescoring(
                model, e, el, *nb, c.blank_id, c.transducer_weight, c.ctc_weight)[2],)
        return found

    card, cpu = (searches(m[side], *m["enc"][side]) for side in ("card", "cpu"))
    for mode in modes:
        out["agreement"][mode] = _nbest_agreement(torch, mode, card[mode], cpu[mode])
        out[f"{mode}_ms"] = synced_ms(dev, lambda: make_offline_decoder(
            m["card"], cfg, mode)(waves, wave_lens))[1]
        print(f"  {mode}: {out[f'{mode}_ms']:.1f} ms on the card")
    if streaming:
        model = m["card"]
        chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
        f = stream_output_factor(c.encoder)
        feats, flens = fbank_batch(waves, wave_lens, cfg.feature, device=dev)
        full, _ = model.encode(feats, flens, chunk, left)
        n = num_chunks(feats.shape[1], chunk, 4, 6)
        # the whole chunks of each request's valid encoder frames (at the
        # full rate: a stride may round an odd count up past the last one)
        valid = subsampled_len(c.encoder.input_layer, flens.long())
        covered = torch.clamp(valid, max=n * chunk) // chunk * chunk
        whole = covered // f  # at the output rate: chunk / f frames a chunk
        stream_lens = covered * 4 + 3  # feature frames whose output is `whole`
        off = rnnt_greedy_decode(model, full, whole, c.blank_id)
        st = streaming_greedy_decode(model, feats, stream_lens, chunk, left, c.blank_id)[:2]
        ok = all(torch.equal(a, b) for a, b in zip(st, off))
        print(f"streaming greedy == chunk-masked offline on the card (chunk {chunk}, {left} "
              f"left, {int(whole.sum())} frames, {int(st[1].sum())} tokens): {ok}")
        require(ok, "streaming tokens differ from chunk-masked offline")
        out["streaming_equals_offline"] = ok
        if stream_beam:
            for n_steps, cw in ((1, 0.0), (cfg.streaming.n_steps, 0.3)):
                ob = rnnt_beam_decode(model, full, whole, c.blank_id, 4, 200, n_steps=n_steps,
                                      ctc_weight=cw, transducer_weight=c.transducer_weight)
                sb = streaming_beam_decode(model, feats, stream_lens, chunk, left, c.blank_id,
                                           4, 200, n_steps, cw, c.transducer_weight)
                ok = torch.equal(sb[0], ob[0]) and torch.equal(sb[1], ob[1])
                print(f"streaming beam == chunk-masked offline beam, n_steps {n_steps}, CTC "
                      f"fusion {cw} ({int(sb[1].sum())} tokens): {ok}")
                require(ok, f"streaming beam tokens differ from chunk-masked offline beam "
                            f"(n_steps {n_steps}, fusion {cw})")
            out["streaming_beam_equals_offline"] = True
    return out


def _zoo_trainer(torch, dev, prune: int) -> dict:
    """12a's trainer: the fused FFN, the embedding predictor and
    `model.rnnt_prune_range=prune` (0: the fused joint loss, 5: the pruned
    one), through `_option_trainer`."""
    sets = {**ZOO["stateless_pruned"], "model.rnnt_prune_range": prune,
            "model.encoder.fused_ffn": True}
    return _option_trainer(
        torch, dev, sets, f"12a trainer, rnnt_prune_range={prune}",
        lambda cfg: cfg.model.rnnt_prune_range == prune
        and cfg.model.predictor.predictor_type == "embedding" and cfg.model.encoder.fused_ffn)


def _option_trainer(torch, dev, sets: dict, label: str, cfg_ok,
                    workload: str = "online_rnnt") -> dict:
    """12a's, 13b's and 14b's trainer: `python -m tpuasr_torch.tools.train
    --workload <workload>` in this process at the card's defaults (bf16,
    fused attention, fbank "default", the fused joint loss) with the
    dotted `sets`, one epoch of the hard synthetic corpus cut as phase 8
    cuts it (48 utterances, batch 12) into a temporary directory under
    build/; `cfg_ok(train.yaml's config)` must hold. Each step synced and
    timed; the peak memory over the run; then one profiled step on the
    first training batch."""
    import tempfile

    import tpuasr_torch.train.loop as loop
    from tpuasr_torch.config import load_yaml
    from tpuasr_torch.data import synthetic_pipeline, tensors
    from tpuasr_torch.tools.profile_trace import profiled_step
    from tpuasr_torch.tools.train import main as train_main
    from tpuasr_torch.train import make_optimizer

    make = loop.make_train_step
    (ROOT / "build").mkdir(exist_ok=True)
    with _timed_steps(torch, loop, "make_train_step") as walls:
        with tempfile.TemporaryDirectory(prefix=f"{workload}-", dir=ROOT / "build") as save_dir:
            args = [f"{k}={list(v) if isinstance(v, tuple) else v}" for k, v in sets.items()] + [
                "data.synth_hard=True", "data.batch_size=12", f"train.save_dir={save_dir}",
                "train.log_dir=", "train.log_every=1"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = train_main(["--workload", workload, "--synthetic", "48", "--epochs", "1",
                              "--set", *args])
            peak = torch.cuda.max_memory_allocated() / 2**30
            cfg = load_yaml(str(Path(save_dir) / "train.yaml"))
    require(cfg_ok(cfg) and cfg.model.compute_dtype == "bfloat16" and cfg.model.fused_joint_loss,
            f"{label}: the trainer's config is not the one asked for")
    require(all(math.isfinite(x) for x in run.train_losses + run.dev_losses)
            and int(run.state.skipped) == 0, f"{label}: a loss is not finite or a step was "
                                             f"skipped")
    ms = sorted(w for w, _ in walls)
    med, audio = ms[len(ms) // 2], sorted(a for _, a in walls)[len(walls) // 2]
    batch = tensors(next(iter(synthetic_pipeline(cfg, 48, seed=0).batches(0))), dev)
    _, busy, wall, kern = profiled_step(
        make(run.state.model, make_optimizer(cfg.optim), cfg), run.state, batch, SEED)
    print(f"{label}: {len(ms)} steps, train loss {run.train_losses}, dev loss "
          f"{run.dev_losses}; step wall (synced) median {med:.1f} ms (min {ms[0]:.1f}, max "
          f"{ms[-1]:.1f}), {audio / med * 1e3:.1f} audio-s/s; peak memory {peak:.3f} GiB; one "
          f"profiled step of batch {list(batch['waves'].shape)}: device busy {busy:.2f} ms of "
          f"{wall:.1f} ms wall, {sum(e.count for e in kern)} device operations")
    return {"steps": len(ms), "step_ms": [w for w, _ in walls], "step_ms_median": med,
            "audio_s_per_s": audio / med * 1e3, "peak_gib": peak,
            "train_losses": run.train_losses, "dev_losses": run.dev_losses,
            "profiled_step_device_busy_ms": busy, "profiled_step_wall_ms": wall,
            "profiled_step_device_operations": sum(e.count for e in kern)}


def _loss_routes(torch, dev, bench) -> dict:
    """12a's loss alone at bench.py's shape, outside the counted run: the
    joint-projected encoder and predictor of the 6b batch's lengths ([12,
    191, 256] and [12, 33, 256], fp32, seeded), the flagship head over 412
    tokens; forward and backward of the pruned loss (band 5, plain PyTorch),
    the fused joint loss (#4/#5, #8/#9) and the materialized one (full
    logits, #8/#9): the median synced wall of 5 calls and the peak memory
    above the inputs."""
    import numpy as np

    from tpuasr_torch.losses import rnnt_loss_from_logits, rnnt_loss_pruned
    from tpuasr_torch.ops import rnnt_loss_fused_mean
    from tpuasr_torch.tools.profile_trace import synced_ms

    b, t, u, d, v = BENCH_B, int(_enc_len(bench["wave_lens"]).max()), BENCH_TOKENS, 256, 412
    r = np.random.default_rng(SEED + 5)
    enc, pred = (torch.from_numpy((0.5 * r.standard_normal(sh)).astype(np.float32)).to(dev)
                 for sh in ((b, t, d), (b, u + 1, d)))
    w = torch.from_numpy((r.standard_normal((d, v)) / 16).astype(np.float32)).to(dev)
    bias = torch.zeros(v, device=dev)
    t_lens, labels, u_lens = _enc_len(bench["wave_lens"]), bench["texts"], bench["text_lens"]
    routes = {
        "pruned_5": lambda *x: rnnt_loss_pruned(*x, labels, t_lens, u_lens, 5, 5),
        "fused": lambda *x: rnnt_loss_fused_mean(*x, labels, t_lens, u_lens, 5),
        "materialized": lambda e, p, w_, b_: rnnt_loss_from_logits(
            torch.tanh(e[:, :, None] + p[:, None]) @ w_ + b_, labels, t_lens, u_lens, 5),
    }
    out = {}
    for name, fn in routes.items():
        xs = [x.clone().requires_grad_() for x in (enc, pred, w, bias)]

        def call():
            loss = fn(*xs)
            loss.backward()
            return loss

        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = sorted(synced_ms(dev, call)[1] for _ in range(5))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        out[name] = {"ms": walls[2], "peak_mib": peak, "loss": float(call().detach())}
        print(f"12a loss route {name} at [{b}, {t}, {u + 1}, {v}]: forward + backward "
              f"{walls[2]:.2f} ms (median synced wall of 5), peak {peak:.1f} MiB above the "
              f"inputs, loss {out[name]['loss']:.4f}")
    return out


def _zoo_step_profile(torch, dev, bench) -> dict:
    """12b's training step at bench.py's configuration and batch (6b: bf16,
    dropout 0.1, dynamic chunks) with the zoo's options: one step, then a
    profiled one (`tools.profile_trace.profiled_step`): its device busy ms,
    wall, device operations, and the peak memory over both."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.tools.profile_trace import profiled_step
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = _zoo(_train_cfg("bfloat16", dropout=True), "zoo")
    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    tx = make_optimizer(cfg.optim)
    step = make_train_step(model, tx, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(TrainState.create(model, tx), bench, SEED)
    state, busy, wall, kern = profiled_step(step, state, bench, SEED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ops = sum(e.count for e in kern)
    require(math.isfinite(float(metrics["loss"])), "12b's bf16 step gave a non-finite loss")
    print(f"12b's step at bench.py's configuration (bf16, batch {list(bench['waves'].shape)}): "
          f"loss {float(metrics['loss']):.4f}; device busy {busy:.2f} ms of {wall:.1f} ms wall "
          f"in {ops} device operations; peak memory {peak:.3f} GiB")
    return {"device_busy_ms": busy, "wall_ms": wall, "device_operations": ops,
            "peak_gib": peak, "loss": float(metrics["loss"])}


def _zoo_phase(torch, dev, data, bench) -> dict:
    """Phase 12a-12c (each configuration the online_rnnt flagship with
    ZOO's fields changed) -> the records."""
    zoo = {}
    print("12a: the stateless pruned transducer")
    step_cfg = _zoo(_train_cfg("float32", dropout=False, fused_ffn=True), "stateless_pruned")
    zoo["stateless_pruned_step"] = _train_card_vs_cpu(
        torch, dev, True, True, step_cfg, "12a: the embedding predictor, rnnt_prune_range=5, "
                                          "fused attention and FFN")
    zoo["stateless_pruned_trainer"] = {p: _zoo_trainer(torch, dev, p) for p in (5, 0)}
    m = _zoo_models(torch, dev, "stateless_pruned", data)
    zoo["stateless_pruned_serving"] = dict(
        _zoo_serve(torch, dev, data, m, ("rnnt_beam", "rnnt_rescoring"), True),
        blank_logit_bias=m["blank_logit_bias"], encoder_max_abs_err=m["encoder_max_abs_err"])
    print("12b: the zoo transducer (rope, GQA, MoE, rms_norm, the conv predictor, HAT)")
    step_cfg = _zoo(_train_cfg("float32", dropout=False), "zoo")
    zoo["zoo_step"] = _train_card_vs_cpu(torch, dev, True, False, step_cfg,
                                         "12b: rope, GQA, MoE, rms_norm, conv predictor, HAT")
    zoo["zoo_step_bf16"] = _zoo_step_profile(torch, dev, bench)
    m = _zoo_models(torch, dev, "zoo", data)
    zoo["zoo_serving"] = dict(_zoo_serve(torch, dev, data, m, ("rnnt_beam",), True),
                              blank_logit_bias=m["blank_logit_bias"],
                              encoder_max_abs_err=m["encoder_max_abs_err"])
    print("12c: full context (FireRed, gated FFNs, batch norm, post-join linear)")
    m = _zoo_models(torch, dev, "full_context", data)
    zoo["full_context_serving"] = dict(_zoo_serve(torch, dev, data, m, ("rnnt_beam",), False),
                                       blank_logit_bias=m["blank_logit_bias"],
                                       encoder_max_abs_err=m["encoder_max_abs_err"])
    return zoo


# ---------------------------------------------------------------------------
# phase 13: the encoder families
# ---------------------------------------------------------------------------

FAMILIES = {
    # wenet's U-Net family: the rate halved at block 5 and recovered at 11;
    # cached streaming needs causal blocks, the chunk-local "stream" time
    # reduction and an even chunk: the flagship's 32 and 6 left chunks
    "squeezeformer": {"model.encoder.encoder_type": "squeezeformer",
                      "model.encoder.reduce_idx": (5,), "model.encoder.recover_idx": (11,),
                      "model.encoder.time_reduction_type": "stream",
                      "streaming.chunk_size": 32, "streaming.num_left_chunks": 6},
    # grouped attention (groups of 3) and a stride after block 3: a chunk must
    # be divisible by factor x group at every block, so 24 (and 8 left
    # chunks: the flagship's 192 frames of left context)
    "efficient_conformer": {"model.encoder.encoder_type": "efficient_conformer",
                            "model.encoder.stride_layer_idx": (3,),
                            "model.encoder.group_size": 3, "model.encoder.input_layer": "conv2d",
                            "model.encoder.static_chunk_size": 24,
                            "streaming.chunk_size": 24, "streaming.num_left_chunks": 8},
    # the configuration the caches refuse (non-causal, the look-ahead "conv"
    # time reduction): streamed by prefix recomputation
    "squeezeformer_full_context": {"model.encoder.encoder_type": "squeezeformer",
                                   "model.encoder.causal": False,
                                   "model.encoder.time_reduction_type": "conv"},
}
CACHED_FAMILIES = ("squeezeformer", "efficient_conformer")


def _prefix_lookahead(model, chunk: int) -> int:
    """Encoder frames a chunk-masked non-causal squeezeformer's output frame
    waits for: each block's conv looks kernel // 2 frames ahead and its
    chunked attention to the end of the frame's chunk, both at the block's
    own rate (f full-rate frames a frame), and the time reduction's conv 2
    frames and the recovery's repeat 1 more."""
    enc = model.encoder
    k = enc.cfg.cnn_module_kernel
    blocks = sum(enc.layer_factor(i) * (chunk // enc.layer_factor(i) - 1 + k // 2)
                 for i in range(enc.cfg.num_blocks))
    return blocks + 3


def _prefix_recompute_check(torch, dev, m, data) -> dict:
    """13c for the configuration the caches refuse: the card model streamed
    by `chunked_prefix_encode` (chunk 32, every left chunk, the receptive
    field's look-ahead `_prefix_lookahead`) over a seeded 60 s request, so
    frames are emitted before the last chunk flushes; the increments,
    joined, must equal the chunk-masked full forward over every frame they
    hold (2e-3, tests/test_prefix_recompute.py's tolerance)."""
    import numpy as np

    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.models.transducer import stream_output_len
    from tpuasr_torch.streaming import chunked_prefix_encode

    model, cfg = m["card"], m["cfg"]
    r = np.random.default_rng(SEED + 13)
    seconds = 60
    wave = (0.1 * r.standard_normal((1, seconds * 48000))).astype(np.float32)
    feats, flens = fbank_batch(wave, np.array([wave.shape[1]]), cfg.feature, device=dev)
    lookahead = _prefix_lookahead(model, CHUNK)
    out_len = lambda n: int(stream_output_len(cfg.model.encoder, torch.tensor(n)))
    encode = lambda f, l: model.encode(f, l, CHUNK, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = chunked_prefix_encode(encode, feats, flens, CHUNK, 4, 6, out_len, lookahead)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    inc = torch.cat(outs, 1)
    full = encode(feats, flens)[0]
    err = float((inc - full[:, :inc.shape[1]]).abs().max())
    before_flush = sum(o.shape[1] for o in outs[:-1])
    print(f"13c prefix recomputation, {seconds} s request ({feats.shape[1]} feature frames, "
          f"{full.shape[1]} encoder frames), chunk {CHUNK}, look-ahead {lookahead} frames: "
          f"{len(outs)} increments, {before_flush} frames emitted before the last flush, "
          f"{inc.shape[1]} in all; max_abs_err against the chunk-masked full forward {err:.3g} "
          f"(tol 2e-3); {ms:.1f} ms of prefix forwards")
    require(inc.shape[1] == full.shape[1] and before_flush > 0,
            "prefix recomputation emitted the wrong frames")
    require(err <= 2e-3, "prefix recomputation differs from the chunk-masked full forward")
    return {"seconds": seconds, "encoder_frames": full.shape[1], "lookahead": lookahead,
            "increments": len(outs), "frames_before_flush": before_flush,
            "max_abs_err": err, "ms": ms}


def _families_phase(torch, dev, data) -> dict:
    """Phase 13a-13c (each configuration the online_rnnt flagship with
    FAMILIES' fields changed) -> the records."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.eval import measure_rtf

    out = {}
    for name in CACHED_FAMILIES:
        for fused in (True, False):
            print(f"13a: {name}, one fp32 step card vs CPU, fused_joint_loss={fused}")
            cfg = _zoo(_train_cfg("float32", dropout=False, fused_joint_loss=fused), name)
            out[f"{name}_step_fused_joint_loss_{fused}"] = _train_card_vs_cpu(
                torch, dev, fused, False, cfg, f"13a: {name}, fused_joint_loss={fused}")
    for name in CACHED_FAMILIES:
        sets = {k: v for k, v in FAMILIES[name].items() if k != "model.encoder.static_chunk_size"}
        out[f"{name}_trainer"] = _option_trainer(
            torch, dev, sets, f"13b trainer, {name}",
            lambda cfg, name=name: cfg.model.encoder.encoder_type == FAMILIES[name][
                "model.encoder.encoder_type"] and cfg.model.encoder.causal)
    for name in CACHED_FAMILIES:
        print(f"13c: {name}, serving")
        m = _zoo_models(torch, dev, name, data)
        rec = _zoo_serve(torch, dev, data, m, ("rnnt_beam", "ctc_prefix_beam", "rnnt_rescoring"),
                         True, stream_beam=True)
        feats, _ = fbank_batch(*data["synthetic"], m["cfg"].feature, device=dev)
        st = measure_rtf(m["card"], feats, m["cfg"])
        print(f"13c {name} streaming greedy RTF (fp32, {feats.shape[0]} streams, "
              f"{st.n_chunks} chunks of {st.chunk_audio_seconds:.3f} s): p50 {st.rtf_p50:.5f} "
              f"p90 {st.rtf_p90:.5f} (probe p50 {st.probe_p50_ms:.4f} ms)")
        out[f"{name}_serving"] = dict(rec, rtf_p50=st.rtf_p50, rtf_p90=st.rtf_p90,
                                      rtf_probe_p50_ms=st.probe_p50_ms,
                                      blank_logit_bias=m["blank_logit_bias"],
                                      encoder_max_abs_err=m["encoder_max_abs_err"])
        del m
    print("13c: squeezeformer_full_context, serving and prefix recomputation")
    m = _zoo_models(torch, dev, "squeezeformer_full_context", data)
    out["squeezeformer_full_context_serving"] = dict(
        _zoo_serve(torch, dev, data, m, ("rnnt_beam", "ctc_prefix_beam", "rnnt_rescoring"),
                   False),
        blank_logit_bias=m["blank_logit_bias"], encoder_max_abs_err=m["encoder_max_abs_err"],
        prefix_recompute=_prefix_recompute_check(torch, dev, m, data))
    return out


def _families_run(torch, dev, data) -> tuple[dict, dict, dict]:
    """Phase 13 as one counted run: launch counts reset before 13a and read
    after 13c, the kernels' card calls recorded, then each held against its
    plain version on them; -> (the records, the launch counts, the kernel
    records)."""
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts

    reset_launch_counts()
    with _recording(torch) as seen:  # the families run, 13a-13c
        families = _families_phase(torch, dev, data)
    launches = dict(LAUNCHES)
    print(f"launches on the families run (13a-13c): {launches}")
    # the families' attention and FFNs are plain in the JAX package: #2, #3,
    # #10 and #11 stay off whatever fused_attention and fused_ffn say
    for name in KERNELS:
        off_path = name in ("relpos_attention", "relpos_attention_bwd", "ffn_fwd", "ffn_bwd")
        require((launches[name] > 0) != off_path,
                f"the families run launched {name} {launches[name]} times")
    require(launches["fbank_tc"] > 0 and launches["fbank_fft"] > 0
            and launches["fbank_fp32"] == 0,
            "the families run did not take fbank's tensor-core route in training and its FFT "
            "route in serving alone")
    print("kernels against their plain versions on the families run's own inputs:")
    records = _trainer_kernel_records(torch, seen, launches, "families", timed=1)
    return families, launches, records


# ---------------------------------------------------------------------------
# phase 14: the Paraformer workload
# ---------------------------------------------------------------------------

PARA_STACKS = {"conformer": {}, "sanm": {"model.encoder.encoder_type": "sanm"}}
PARA_BEAM = 10


def _para_cfg(stack: str, dropout: bool = True):
    """The paraformer workload at the repo's defaults, as the trainer builds
    it: 412 tokens, the NAR decoder of model.att_decoder (6 blocks, 4 heads,
    FFN 1024, lsm_weight 0.1, the sampler at 0.75), max 64 tokens, <eos> 3,
    the CIF head's tail threshold 0.45 and dropout 0.1; the conformer stack
    of EncoderConfig's defaults (12 non-causal rel-pos blocks, d256, 4
    heads, FFN 1024, conv 31) with `fused_attention`, or the SANM stack (LFR
    7/6, 12 blocks at d256, FSMN kernel 11); fp32, fbank "highest"; without
    `dropout` the encoder's rates 0."""
    from tpuasr_torch.config import Config, override

    cfg = override(Config(), PARA_STACKS[stack])
    cfg.model.encoder.fused_attention = True
    if not dropout:
        cfg.model.encoder.dropout_rate = cfg.model.encoder.positional_dropout_rate = 0.0
    return cfg


def _para_model(cfg, device, **extra):
    """The trainer's Paraformer (`paraformer_config`, seed train.seed), with
    `extra` fields set (the CTC and timestamp branches, the CIF dropout)."""
    from tpuasr_torch.models import Paraformer, init_weights
    from tpuasr_torch.tools.train import paraformer_config

    return init_weights(Paraformer(paraformer_config(cfg, **extra), device), cfg.train.seed)


def _para_card_vs_cpu(torch, dev, stack: str, **extra) -> dict:
    """14a: one fp32 training step of the Paraformer card vs CPU on 6a's
    batch ([2, 256, 80] seeded features x 16 tokens), no dropout, the
    glancing sampler on the same seeded scores on both sides; held as 6a
    holds a step."""
    import numpy as np

    from tpuasr_torch.train import make_optimizer

    cfg = _para_cfg(stack, dropout=False)
    r = np.random.default_rng(SEED + 11)
    b, t, u = 2, 256, 16
    host = (torch.from_numpy(r.standard_normal((b, t, 80)).astype(np.float32)),
            torch.tensor([t, 200], dtype=torch.int32),
            torch.from_numpy(r.integers(6, cfg.model.vocab_size, (b, u))),
            torch.tensor([u, 11], dtype=torch.int32))
    scores = torch.from_numpy(r.uniform(size=(b, u + 1)).astype(np.float32))
    tx = make_optimizer(cfg.optim)
    res = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = _para_model(cfg, device, cif_dropout=0.0, **extra).train()
        out = model(*(x.to(device) for x in host), sampler_scores=scores.to(device))
        res[side] = _step_side(torch, model, tx, out)
    label = f"14a: Paraformer {stack} stack, fp32 step card vs CPU on [2, 256, 80] x 16 tokens"
    if extra:
        label += f" ({', '.join(f'{k}={v}' for k, v in extra.items())})"
    return _step_card_vs_cpu(
        torch, tx, res, label, "fp32 sums in another order through 12 encoder and 6 decoder "
        "blocks, the attention kernels' 3xTF32 products, the CIF cumsum, the CTC lattice")


def _fit_cif_bias(torch, model, enc, elens, target: float) -> float:
    """Set the CIF head's output bias (bisection on [-16, 16]) so that the
    weights sum to `target` tokens per encoder frame; -> the bias. At random
    weights they sit near 0.5 a frame and the counts clip at max_tokens."""
    from tpuasr_torch.nn.masks import make_pad_mask

    bias = model.predictor.cif_output.bias
    mask = ~make_pad_mask(elens, enc.shape[1])
    rate = lambda: float(model.predictor.alpha(enc, mask).sum() / elens.sum())
    lo, hi = -16.0, 16.0
    with torch.no_grad():
        free = rate()
        for _ in range(30):
            bias.fill_(0.5 * (lo + hi))
            lo, hi = (lo, 0.5 * (lo + hi)) if rate() > target else (0.5 * (lo + hi), hi)
        bias.fill_(0.5 * (lo + hi))
        got = rate()
    print(f"CIF output bias {0.5 * (lo + hi):.4f}: {got:.4f} tokens a frame (target "
          f"{target:.4f}; {free:.4f} with the seeded bias)")
    return 0.5 * (lo + hi)


def _cif_margins(torch, sums: dict) -> dict:
    """The margin rule for CIF's floors, card against CPU: sums = {side:
    (the fired weights' cumsum [B, T'+1], their sum [B], ...), each computed
    on its side's device, copied to the CPU}. d = the largest |card - CPU|
    of the cumsum and of the sum; a row's count margin is its CPU sum's
    distance to the nearest integer, its peak margin the least such
    distance over its cumsum. -> d, each row's margins and which rows lie
    inside 2d."""
    c = {s: v[0] for s, v in sums.items()}
    tot = {s: v[1] for s, v in sums.items()}
    d = max(float((c["card"] - c["cpu"]).abs().max()),
            float((tot["card"] - tot["cpu"]).abs().max()))
    dist = lambda x: (x - torch.round(x)).abs()
    count_margin = dist(tot["cpu"])
    peak_margin = dist(c["cpu"]).amin(dim=1)
    return {"d": d, "count_margin": count_margin, "peak_margin": peak_margin,
            "count_inside": [i for i, m in enumerate(count_margin.tolist()) if m <= 2 * d],
            "peak_inside": [i for i, m in enumerate(peak_margin.tolist()) if m <= 2 * d]}


def _para_serve(torch, dev, data, stack: str) -> dict:
    """14c for one stack: fp32 serving of the fixture requests, card vs CPU,
    after the CIF bias is fitted to the transcripts' tokens a frame.
    `paraformer_greedy`: counts and peaks equal on every row outside the
    margin rule's 2d, tokens identical where the counts agree;
    `paraformer_beam` (beam 10): phase 4b's 2d rule on the n-best of the
    rows whose counts agree; `greedy_decode_with_times`: the fire frames
    equal where the peaks are held; `make_offline_decoder` in each mode
    gives the model's own search on the card; each mode's synced latency
    after a warm-up call; then `evaluate` in both modes on a checkpoint of
    these weights, on the card."""
    import tempfile

    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.config import save_yaml
    from tpuasr_torch.eval import make_offline_decoder
    from tpuasr_torch.nn.cif import cif_peaks
    from tpuasr_torch.nn.masks import make_pad_mask
    from tpuasr_torch.tools import evaluate
    from tpuasr_torch.tools.profile_trace import synced_ms
    from tpuasr_torch.train import TrainState, make_optimizer, save_checkpoint

    waves, wave_lens = data["fixture"]
    cfg = _para_cfg(stack)
    models = {"card": _para_model(cfg, dev), "cpu": _para_model(cfg, torch.device("cpu"))}
    feats, enc = {}, {}
    for side, m in models.items():
        feats[side] = fbank_batch(waves, wave_lens, cfg.feature, device=m.device)
        enc[side] = m.encode(*feats[side])
    k = models["card"].cfg.max_tokens
    target = float(data["text_lens"].sum()) / float(enc["cpu"][1].sum())
    bias = _fit_cif_bias(torch, models["card"], *enc["card"], target)
    with torch.no_grad():
        models["cpu"].predictor.cif_output.bias.fill_(bias)
    sums = {}
    for side, m in models.items():  # each side's cumsum, sum and peaks on its own device
        e, el = enc[side]
        with torch.no_grad():
            a = m.predictor(e, ~make_pad_mask(el, e.shape[1]), k)[2]
        sums[side] = [x.cpu() for x in (torch.cumsum(a, dim=1), a.sum(dim=1), cif_peaks(a))]
    mg = _cif_margins(torch, sums)
    out = {"cif_output_bias": bias, "d": mg["d"], "count_inside_2d": mg["count_inside"],
           "peak_inside_2d": mg["peak_inside"]}
    found = {side: (m.greedy_decode_with_times(*feats[side]),
                    m.beam_decode(*feats[side], PARA_BEAM)) for side, m in models.items()}
    (gc, bc), (gp, bp) = ([[x.cpu() for x in part] for part in found[s]]
                          for s in ("card", "cpu"))
    n = len(wave_lens)
    held = [i for i in range(n) if i not in mg["count_inside"]]
    require(all(int(gc[1][i]) == int(gp[1][i]) for i in held),
            f"{stack}: a count outside the margin rule's 2d differs card vs CPU")
    same_count = [i for i in range(n) if int(gc[1][i]) == int(gp[1][i])]
    require(all(torch.equal(gc[0][i], gp[0][i]) for i in same_count),
            f"{stack}: paraformer_greedy tokens differ where the counts agree")
    peak_rows = [i for i in range(n) if i not in mg["peak_inside"]]
    require(all(torch.equal(sums["card"][2][i], sums["cpu"][2][i]) for i in peak_rows),
            f"{stack}: CIF peaks outside the margin rule's 2d differ card vs CPU")
    require(all(torch.equal(gc[2][i], gp[2][i]) for i in peak_rows if i in same_count),
            f"{stack}: fire times differ where the peaks are held")
    tokens = int(gp[1].sum())
    print(f"14c {stack}: d = {mg['d']:.3g} (the largest |card - CPU| of the fired weights' "
          f"cumsum and sum); rows inside 2d: counts {mg['count_inside']}, peaks "
          f"{mg['peak_inside']} of {n}; least CPU margins: count "
          f"{float(mg['count_margin'].min()):.4g}, peak {float(mg['peak_margin'].min()):.4g}; "
          f"counts card {gc[1].tolist()} CPU {gp[1].tolist()} ({tokens} tokens, target "
          f"{int(data['text_lens'].sum())}); greedy tokens identical on the {len(same_count)} "
          f"rows whose counts agree; peaks and fire times identical on {len(peak_rows)} rows")
    rows = torch.tensor(same_count)
    nb = lambda x: (x[0][rows], x[2][rows, None].expand(-1, PARA_BEAM), x[1][rows])
    out["beam_agreement"] = _nbest_agreement(torch, f"14c {stack} paraformer_beam", nb(bc),
                                             nb(bp))
    lat = {}
    for mode in ("paraformer_greedy", "paraformer_beam"):
        dec = make_offline_decoder(models["card"], cfg, mode, beam_size=PARA_BEAM)
        toks, lens = dec(waves, wave_lens)
        ref = (gc[0], gc[1]) if mode == "paraformer_greedy" else (bc[0][:, 0], bc[2])
        require(torch.equal(toks.cpu(), ref[0]) and torch.equal(lens.cpu(), ref[1]),
                f"make_offline_decoder({mode!r}) differs from the model's search on the card")
        lat[mode] = synced_ms(dev, lambda: dec(waves, wave_lens))[1]
    lat["greedy_decode_with_times"] = synced_ms(
        dev, lambda: models["card"].greedy_decode_with_times(*feats["card"]))[1]
    print(f"14c {stack} latency, fp32, the {n} fixture requests, synced after a warm-up call: "
          + ", ".join(f"{m} {v:.1f} ms" for m, v in lat.items()))
    out["latency_ms"] = lat
    walls = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="para-", dir=ROOT / "build") as save_dir:
        save_yaml(cfg, str(Path(save_dir) / "train.yaml"))
        ckpt = str(Path(save_dir) / "latest")
        save_checkpoint(ckpt, TrainState.create(models["card"], make_optimizer(cfg.optim)),
                        {"epoch": 0, "step": 0})
        for mode in ("paraformer_greedy", "paraformer_beam"):
            res, walls[mode] = synced_ms(dev, lambda: evaluate.main(
                ["--checkpoint", ckpt, "--workload", "paraformer", "--mode", mode,
                 "--synthetic", "16", "--beam_size", str(PARA_BEAM), "--max_samples", "0"]))
            require(res.counts.ref_len > 0, f"evaluate --mode {mode} decoded nothing")
    print(f"14c {stack} evaluate CLI walls (synced, the build and restore included, 16 "
          f"synthetic utterances): " + ", ".join(f"{m} {v / 1e3:.2f} s" for m, v in walls.items()))
    out["evaluate_wall_s"] = {m: v / 1e3 for m, v in walls.items()}
    return out


def _para_phase(torch, dev, data) -> dict:
    """Phase 14a-14c, each part's launches checked from the counts' deltas:
    the conformer stack's trainer launches #1, #2 and #3, 14a's CTC-branch
    step #6 and #7, and the SANM stack's parts (its step, trainer and
    serving) none of #2, #3, #10 or #11."""
    from tpuasr_torch.ops import LAUNCHES

    out, deltas = {}, {}

    @contextlib.contextmanager
    def counted(part):
        before = dict(LAUNCHES)
        yield
        deltas[part] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}

    for stack, extra in (("conformer", {}), ("conformer", {"ctc_weight": 0.3,
                                                           "timestamp_branch": True}),
                         ("sanm", {})):
        part = f"14a_{stack}" + ("_ctc_tp" if extra else "")
        with counted(part):
            out[part] = _para_card_vs_cpu(torch, dev, stack, **extra)
    t0 = time.perf_counter()
    for stack in PARA_STACKS:
        with counted(f"14b_{stack}"):
            out[f"14b_{stack}"] = _option_trainer(
                torch, dev, PARA_STACKS[stack], f"14b trainer, Paraformer {stack} stack",
                lambda cfg, stack=stack: (cfg.model.encoder.encoder_type == "sanm")
                == (stack == "sanm") and cfg.model.att_decoder.sampler, workload="paraformer")
    print(f"(14b: {time.perf_counter() - t0:.1f} s)")
    for stack in PARA_STACKS:
        with counted(f"14c_{stack}"):
            out[f"14c_{stack}"] = _para_serve(torch, dev, data, stack)
    for part, d in deltas.items():
        print(f"launches in {part}: { {k: v for k, v in d.items() if v} }")
    conf = deltas["14b_conformer"]
    require(conf["fbank"] > 0 and conf["relpos_attention"] > 0
            and conf["relpos_attention_bwd"] > 0,
            "the conformer stack's trainer did not launch #1, #2 and #3")
    require(deltas["14a_conformer_ctc_tp"]["ctc_alpha"] > 0
            and deltas["14a_conformer_ctc_tp"]["ctc_beta_grad"] > 0,
            "14a's CTC-branch step did not launch #6 and #7")
    for part in ("14a_sanm", "14b_sanm", "14c_sanm"):
        for name in ("relpos_attention", "relpos_attention_bwd", "ffn_fwd", "ffn_bwd"):
            require(deltas[part][name] == 0, f"{part} (the SANM stack) launched {name}")
    out["launches_by_part"] = {p: {k: v for k, v in d.items() if v} for p, d in deltas.items()}
    return out


def _para_run(torch, dev, data) -> tuple[dict, dict, dict]:
    """Phase 14 as one counted run: launch counts reset before 14a and read
    after 14c, the kernels' card calls recorded, then each held against its
    plain version on them; -> (the records, the launch counts, the kernel
    records)."""
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts

    reset_launch_counts()
    with _recording(torch) as seen:  # the paraformer run, 14a-14c
        para = _para_phase(torch, dev, data)
    launches = dict(LAUNCHES)
    print(f"launches on the paraformer run (14a-14c): {launches}")
    for name in KERNELS:
        on_path = name in ("fbank", "relpos_attention", "relpos_attention_bwd", "ctc_alpha",
                           "ctc_beta_grad")
        require((launches[name] > 0) == on_path,
                f"the paraformer run launched {name} {launches[name]} times")
    require(launches["fbank_tc"] > 0 and launches["fbank_fft"] > 0
            and launches["fbank_fp32"] == 0,
            "the paraformer run did not take fbank's tensor-core route in training and its FFT "
            "route in serving alone")
    print("kernels against their plain versions on the paraformer run's own inputs:")
    records = _trainer_kernel_records(torch, seen, launches, "paraformer", timed=1)
    return para, launches, records


# ---------------------------------------------------------------------------
# phase 15: Whisper
# ---------------------------------------------------------------------------

WHISPER_BEAM, WHISPER_MAX_TOKENS, WHISPER_STEP_B = 4, 24, 4


def _whisper_cfg():
    """Whisper at WhisperConfig's defaults: 412 tokens, blank 5, 2
    languages, sot 2 and eot 3, a 6-block decoder (4 heads, FFN 1024),
    lsm_weight 0.1, ctc_weight 0; the conformer of EncoderConfig's defaults
    (12 non-causal rel-pos blocks, d256, 4 heads, FFN 1024, conv 31, conv2d
    subsampling) with `fused_attention` and `fused_ffn`, as the card's
    trainer sets them; fp32; every dropout rate 0, so a training step held
    card vs CPU needs no generator."""
    from tpuasr_torch.config import EncoderConfig
    from tpuasr_torch.models import WhisperConfig

    return WhisperConfig(encoder=EncoderConfig(fused_attention=True, fused_ffn=True,
                                               dropout_rate=0.0, positional_dropout_rate=0.0))


def _whisper_model(torch, cfg, device, eot_bias: float = 0.0):
    from tpuasr_torch.models import WhisperModel, init_weights

    model = init_weights(WhisperModel(cfg, device), SEED)
    with torch.no_grad():
        model.decoder.output_layer.bias[cfg.special.eot] = eot_bias
    return model


def _whisper_rows(torch, n: int):
    """Each request's language and task: the 2 languages and transcribe,
    translate and VAD in turn."""
    i = torch.arange(n)
    return i % 2, i % 3


def _fit_eot_bias(torch, model, enc, elens, langs, tasks, target: float) -> tuple[float, float]:
    """Set the decoder's eot logit (bisection on [-16, 16]) so that greedy
    decoding's hypotheses average `target` tokens; -> (the bias, the mean
    length it gives). With random weights the search otherwise ends at once
    or never."""
    from tpuasr_torch.models import whisper_greedy_decode

    bias, eot = model.decoder.output_layer.bias, model.cfg.special.eot

    def mean_len(b: float) -> float:
        with torch.no_grad():
            bias[eot] = b
        lens = whisper_greedy_decode(model, enc, elens, langs, tasks, WHISPER_MAX_TOKENS)[1]
        return float(lens.float().mean())

    free = mean_len(0.0)
    lo, hi = -16.0, 16.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if mean_len(mid) > target else (lo, mid)
    got = mean_len(hi)
    print(f"eot logit bias {hi:.4f}: greedy hypotheses average {got:.2f} tokens (target "
          f"{target:.1f}, max_tokens {WHISPER_MAX_TOKENS}); {free:.2f} with no bias")
    return hi, got


def _whisper_phase(torch, dev, data) -> dict:
    """15a-15c (see the module's docstring)."""
    import numpy as np

    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.config import Config
    from tpuasr_torch.models import whisper_beam_decode, whisper_greedy_decode
    from tpuasr_torch.tools.profile_trace import synced_ms
    from tpuasr_torch.train import make_optimizer

    cfg = _whisper_cfg()
    feature = Config().feature
    waves, wave_lens = data["fixture"]
    n = len(wave_lens)
    langs, tasks = _whisper_rows(torch, n)
    out = {}

    # 15a: a loss + backward + GuardedAdam step, card vs CPU
    b = WHISPER_STEP_B
    feats, flens = fbank_batch(waves[:b], wave_lens[:b], feature, device=dev)
    r = np.random.default_rng(SEED + 15)
    text_lens = torch.tensor([16, 11, 7, 13])
    host = (feats.cpu(), flens.cpu(), torch.from_numpy(r.integers(12, cfg.vocab_size, (b, 16))),
            text_lens, langs[:b], tasks[:b])
    tx = make_optimizer(Config().optim)
    res = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = _whisper_model(torch, cfg, device).train()
        res[side] = _step_side(torch, model, tx, model(*(x.to(device) for x in host)))
    out["15a_step"] = _step_card_vs_cpu(
        torch, tx, res, f"15a: Whisper fp32 step card vs CPU on [{b}, {feats.shape[1]}, 80] "
        f"fixture features x labels {text_lens.tolist()} (tasks {tasks[:b].tolist()}, "
        f"languages {langs[:b].tolist()})",
        "fp32 sums in another order through 12 encoder and 6 decoder blocks, the attention "
        "kernels' 3xTF32 products")
    del res

    # 15b-15c: greedy and beam decoding of the fixture requests
    models = {"card": _whisper_model(torch, cfg, dev),
              "cpu": _whisper_model(torch, cfg, torch.device("cpu"))}
    enc = {}
    for side, m in models.items():
        enc[side] = m.encode(*fbank_batch(waves, wave_lens, feature, device=m.device))
    eot, out["greedy_mean_len"] = _fit_eot_bias(torch, models["card"], *enc["card"], langs,
                                                tasks, WHISPER_MAX_TOKENS / 2)
    require(WHISPER_MAX_TOKENS / 4 <= out["greedy_mean_len"] <= 3 * WHISPER_MAX_TOKENS / 4,
            f"Whisper greedy hypotheses average {out['greedy_mean_len']:.2f} tokens, outside "
            f"a quarter to three quarters of {WHISPER_MAX_TOKENS}")
    out["eot_logit_bias"] = eot
    with torch.no_grad():
        models["cpu"].decoder.output_layer.bias[cfg.special.eot] = eot
    greedy = lambda side: whisper_greedy_decode(models[side], *enc[side], langs, tasks,
                                                WHISPER_MAX_TOKENS)
    beam = lambda side: whisper_beam_decode(models[side], *enc[side], langs, tasks,
                                            WHISPER_BEAM, WHISPER_MAX_TOKENS, nbest=True)
    (gt, gl), (pt, pl) = greedy("card"), greedy("cpu")
    same = torch.equal(gt.cpu(), pt) and torch.equal(gl.cpu(), pl)
    print(f"15b: Whisper greedy card vs CPU on the {n} fixture requests (tasks "
          f"{tasks.tolist()}, languages {langs.tolist()}): tokens identical {same} "
          f"({int(pl.sum())} tokens, lens {pl.tolist()})")
    require(same, "Whisper greedy tokens on the card differ from the CPU run")
    found = {}
    for side in ("card", "cpu"):
        _, _, scores, (nb_t, nb_l) = beam(side)
        found[side] = (nb_t, nb_l, scores)
    out["beam_agreement"] = _nbest_agreement(torch, f"15c: Whisper beam {WHISPER_BEAM}",
                                             found["card"], found["cpu"])
    card = models["card"]
    lat = {"encode": synced_ms(dev, lambda: card.encode(*fbank_batch(
               waves, wave_lens, feature, device=dev)))[1],
           "greedy": synced_ms(dev, lambda: greedy("card"))[1],
           "beam": synced_ms(dev, lambda: beam("card"))[1]}
    print(f"15c: Whisper latency, fp32, the {n} fixture requests, synced after a warm-up "
          f"call: fbank + encode {lat['encode']:.1f} ms, greedy {lat['greedy']:.1f} ms, beam "
          f"{WHISPER_BEAM} {lat['beam']:.1f} ms ({WHISPER_MAX_TOKENS} tokens at most)")
    out["latency_ms"] = lat
    return out


def _whisper_run(torch, dev, data) -> tuple[dict, dict, dict]:
    """Phase 15 as one counted run: launch counts reset before 15a and read
    after 15c, the kernels' card calls recorded, then each held against its
    plain version on them; -> (the records, the launch counts, the kernel
    records)."""
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts

    reset_launch_counts()
    with _recording(torch) as seen:  # the whisper run, 15a-15c
        whisper = _whisper_phase(torch, dev, data)
    launches = dict(LAUNCHES)
    print(f"launches on the whisper run (15a-15c): {launches}")
    for name in KERNELS:
        on_path = name in ("fbank", "relpos_attention", "relpos_attention_bwd", "ffn_fwd",
                           "ffn_bwd")
        require((launches[name] > 0) == on_path,
                f"the whisper run launched {name} {launches[name]} times")
    require(launches["fbank_fft"] == launches["fbank"],
            "the whisper run did not take fbank's FFT route (precision \"highest\") alone")
    print("kernels against their plain versions on the whisper run's own inputs:")
    records = _trainer_kernel_records(torch, seen, launches, "whisper", timed=1)
    return whisper, launches, records


# ---------------------------------------------------------------------------
# phase 16: the serving export
# ---------------------------------------------------------------------------

# the fixture's streams played 8 times over run 9 chunks, past the
# attention cache's capacity of LEFT chunks
EXPORT_N_STEPS, EXPORT_MAX_TOKENS, EXPORT_LOOPS = 3, 200, 8


def _looped(np, waves, wave_lens, times: int):
    """Each request's valid samples played `times` over, zero-padded."""
    lens = wave_lens * times
    out = np.zeros((len(waves), int(lens.max())), waves.dtype)
    for i, (w, k) in enumerate(zip(waves, wave_lens)):
        out[i, :k * times] = np.tile(w[:k], times)
    return out, lens


def _export_phase(torch, dev, data, blank_bias: float) -> tuple[dict, dict, dict]:
    """16 (see the module's docstring); -> (the records, the artifact run's
    launch counts, its kernel records)."""
    import os
    import tempfile

    import numpy as np

    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import streaming_greedy_decode
    from tpuasr_torch.decode.rnnt_streaming import init_streaming_state, process_chunk
    from tpuasr_torch.export import export_streaming, load_exported
    from tpuasr_torch.models import stream_output_len
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts
    from tpuasr_torch.streaming import chunk_windows, num_chunks
    from tpuasr_torch.tools import export_stream
    from tpuasr_torch.tools.profile_trace import synced_ms

    cfg = _flagship("float32", fused_ffn=True)
    s = cfg.streaming
    s.chunk_size, s.num_left_chunks, s.n_steps = CHUNK, LEFT, EXPORT_N_STEPS
    model = _model(torch, cfg, dev, blank_bias)
    blank = cfg.model.blank_id
    waves, wave_lens = data["fixture"]
    sets = {"fixture": (waves, wave_lens),
            f"fixture_x{EXPORT_LOOPS}": _looped(np, waves, wave_lens, EXPORT_LOOPS)}
    inputs = {}
    for name, (w, wl) in sets.items():
        feats, flens = fbank_batch(w, wl, cfg.feature, device=dev)
        n = num_chunks(feats.shape[1], CHUNK, 4, 6)
        inputs[name] = (chunk_windows(feats, CHUNK, 4, 6, n),
                        stream_output_len(cfg.model.encoder, flens),
                        streaming_greedy_decode(model, feats, flens, CHUNK, LEFT, blank,
                                                EXPORT_N_STEPS, EXPORT_MAX_TOKENS)[:2])
    b = len(wave_lens)
    out = {"n_steps": EXPORT_N_STEPS, "chunks": {k: len(v[0]) for k, v in inputs.items()}}

    def chain(step, name):
        """Every chunk of `name`'s streams through `step` -> (the final
        state, each chunk's synced ms)."""
        windows, enc_lens, _ = inputs[name]
        st = init_streaming_state(model, b, CHUNK, LEFT, blank, EXPORT_MAX_TOKENS, enc_lens)
        times = []
        for w in windows:
            st, ms = synced_ms(dev, lambda: step(w, st))
            times.append(ms)
        return st, times

    eager = lambda w, st: process_chunk(model, w, st, blank, EXPORT_N_STEPS)
    eager_sf = lambda w, st: process_chunk(model, w, st, blank, EXPORT_N_STEPS, sync_free=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="export-", dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        manifest = export_streaming(model, cfg, out_dir, batch=b, max_tokens=EXPORT_MAX_TOKENS)
        t_export = time.perf_counter() - t0
        fns = load_exported(out_dir)
        t_load = time.perf_counter() - t0 - t_export
        sizes = {k: os.path.getsize(Path(out_dir) / v["file"]) / 2**20
                 for k, v in manifest["functions"].items()}
        print(f"16: exported {sorted(manifest['functions'])} for {b} streams on "
              f"{manifest['functions']['process_chunk']['platforms']} in {t_export:.1f} s, "
              f"loaded in {t_load:.1f} s; MiB {', '.join(f'{k} {v:.1f}' for k, v in sizes.items())}")
        out.update(export_s=t_export, load_s=t_load, artifact_mib=sizes)
        require(manifest["functions"]["process_chunk"]["platforms"] == ["cuda"],
                "the artifacts were not traced for the card")
        for step in (fns["process_chunk"], eager, eager_sf):  # first calls, untimed
            step(inputs["fixture"][0][0], init_streaming_state(
                model, b, CHUNK, LEFT, blank, EXPORT_MAX_TOKENS, inputs["fixture"][1]))
        reset_launch_counts()
        with _recording(torch, only=("ffn_fwd",)) as seen:  # the export run
            got = {name: chain(fns["process_chunk"], name) for name in inputs}
        launches = dict(LAUNCHES)
        chunks = sum(len(v[0]) for v in inputs.values())
        print(f"launches on the export run (the loaded process_chunk over {chunks} chunks): "
              f"{ {k: v for k, v in launches.items() if v} }")
        for name in KERNELS:
            want = 24 * chunks if name == "ffn_fwd" else 0  # 12 blocks x 2 FFNs a chunk
            require(launches[name] == want, f"the export run launched {name} "
                                            f"{launches[name]} times, not {want}")
        lat = {}
        steps = {"artifact": fns["process_chunk"], "eager": eager, "eager_sync_free": eager_sf}
        for name, (windows, _, (ref_t, ref_l)) in inputs.items():
            st, t_art = got[name]
            st_e, t_e = chain(eager, name)
            st_sf, t_sf = chain(eager_sf, name)
            for label, x in (("artifact", st), ("eager sync_free", st_sf), ("eager", st_e)):
                require(torch.equal(x.dec.hyp[:, :EXPORT_MAX_TOKENS], ref_t)
                        and torch.equal(x.dec.hyp_len, ref_l),
                        f"16 {name}: the {label} process_chunk's tokens differ from "
                        f"streaming_greedy_decode")
            if name != "fixture":
                require(int(st.enc.offset) > CHUNK * LEFT, f"16 {name}: the streams ended "
                        f"at offset {int(st.enc.offset)}, inside the cache's capacity")
            med = lambda t: sorted(t)[len(t) // 2]
            lat[name] = {"artifact": med(t_art), "eager": med(t_e), "eager_sync_free": med(t_sf)}
            print(f"16 {name}: {len(windows)} chunks of {b} streams, offset "
                  f"{int(st.enc.offset)} (cache capacity {CHUNK * LEFT}); the artifact's, the "
                  f"eager sync-free and the eager early-exit tokens identical to "
                  f"streaming_greedy_decode ({int(ref_l.sum())} tokens); per-chunk ms "
                  f"(median, synced): artifact {lat[name]['artifact']:.2f}, eager sync_free "
                  f"{lat[name]['eager_sync_free']:.2f}, eager {lat[name]['eager']:.2f}")
        out["chunk_ms_median"] = lat
        # the device's share of one chunk (the first of the looped streams)
        windows, enc_lens, _ = inputs[f"fixture_x{EXPORT_LOOPS}"]
        fresh = init_streaming_state(model, b, CHUNK, LEFT, blank, EXPORT_MAX_TOKENS, enc_lens)
        busy = {}
        for label, step in steps.items():
            ms, kern = _decode_busy(torch, step, windows[0], fresh)
            busy[label] = {"device_busy_ms": ms, "device_operations": sum(e.count for e in kern)}
        print(f"16: one chunk of {b} streams, device busy ms (profiler) and device operations: "
              + ", ".join(f"{k} {v['device_busy_ms']:.2f} ms in {v['device_operations']}"
                          for k, v in busy.items()))
        out["chunk_device"] = busy
        print("#10 against its plain version on the inputs the loaded artifact gave it:")
        records = _trainer_kernel_records(torch, seen, launches, "export", timed=1)
    with tempfile.TemporaryDirectory(prefix="export-cli-", dir=ROOT / "build") as cli_dir:
        argv = ["--out", cli_dir, "--verify", "--max_tokens", "8", "--device", "cuda",
                "--set", "model.encoder.num_blocks=1", "model.encoder.output_size=64",
                "model.encoder.attention_heads=2", "model.encoder.linear_units=128",
                "model.encoder.cnn_module_kernel=3", "model.encoder.static_chunk_size=4",
                "model.encoder.fused_ffn=True", "streaming.chunk_size=4", "streaming.n_steps=2"]
        cli, wall = synced_ms(dev, lambda: export_stream.main(argv))
        require(all(v["platforms"] == ["cuda"] for v in cli["functions"].values()),
                "export_stream --device cuda traced for another device")
        print(f"16: tools/export_stream --verify on the card (1 block, d64, fused_ffn): "
              f"{sorted(cli['functions'])} in {wall / 1e3:.1f} s")
        out["cli_wall_s"] = wall / 1e3
    return out, launches, records


# ---------------------------------------------------------------------------
# phase 17: the parallel layer
# ---------------------------------------------------------------------------

PARALLEL_CASES = ("none", "zero1", "zero3", "shard_joint", "shard_joint_hat",
                  "shard_joint_postjoin")
SPLIT_CASES = PARALLEL_CASES[3:]
PARALLEL_RANKS = 2
PARALLEL_WAIT_S = 420  # the ranks' whole run, kernels held against plain included
PARALLEL_PG_S = 300    # the bound of every collective of a rank
TP_SHAPE = (8, 512, 128, 4096, 256)  # B, T, U, V, D: fp32 logits of 8.66 GB (tp_joint_bench)
COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_reduce_min", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast", "barrier")


def _parallel_cfg(case: str):
    """Phase 6a's fp32 flagship (no dropout, the static chunk) for a phase 17
    case: the fused joint loss at ZeRO stage `case`, or with "shard_joint*"
    the materialized loss with the vocabulary split over 2 model ranks (the
    plain head, the HAT, a post-join linear)."""
    split = case in SPLIT_CASES
    cfg = _train_cfg("float32", dropout=False, fused_joint_loss=not split)
    if split:
        cfg.model.shard_joint = True
        cfg.mesh.model_parallel_size = PARALLEL_RANKS
        cfg.model.joint.hat_joint = case == "shard_joint_hat"
        cfg.model.joint.postjoin_linear = case == "shard_joint_postjoin"
    else:
        cfg.mesh.zero_stage = case
    return cfg


def _parallel_side(torch, cfg, dev, batch, mesh=None) -> dict:
    """One train step of `cfg` from seed-0 weights through `make_train_step`
    (with a `mesh`: this rank's rows, in the ZeRO layout of cfg.mesh) -> a
    `_step_side` record: the global losses and gradient norm, the reduced
    gradient, the weights before and after, the whole Adam state, and with
    a mesh the collectives the step issued."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.parallel import (
        assert_sharded, record_collectives, shard_batch, shard_train_state, whole_state,
    )
    from tpuasr_torch.train import GuardedAdam, TrainState, make_train_step
    from tpuasr_torch.train.optim import flatten, unflatten

    class Keep(GuardedAdam):
        def update_guarded(self, grads, state, params, finite, lr_scale=1.0, grad_norm=None,
                           zero=None):
            self.kept = flatten(grads).clone()
            return super().update_guarded(grads, state, params, finite, lr_scale, grad_norm,
                                          zero)

    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    named = list(model.named_parameters())
    p0 = [p.detach().cpu().clone() for _, p in named]
    tx = Keep(cfg.optim)
    state = TrainState.create(model, tx)
    if mesh is not None:
        state = shard_train_state(state, mesh, cfg.mesh.zero_stage)
        batch = shard_batch(batch, mesh)
    with record_collectives() as colls:  # the step's alone, not the set-up's or the gather's
        state, m = make_train_step(model, tx, cfg, mesh)(state, batch, 1)
    if mesh is not None and mesh.data_size > 1:
        assert_sharded(state, mesh, cfg.mesh.zero_stage)
    with whole_state(state) as whole:
        p1 = [p.detach().cpu().clone() for p in model.parameters()]
        st = [None if x is None else x.cpu() for x in whole.opt_state]
    return {"losses": {k: float(m[k]) for k in ("loss", "loss_rnnt", "loss_ctc")},
            "gn": float(m["grad_norm"]),
            "grads": [g.cpu() for g in unflatten(tx.kept, [p for _, p in named])],
            "p0": p0, "p1": p1, "state": st, "names": [n for n, _ in named],
            "collectives": [(c.op, c.payload, c.groups) for c in colls]}


def _parallel_decode(torch, dev, data, blank_bias: float, mesh=None):
    """Streaming greedy (chunk 32, 6 left chunks) of the fp32 flagship with
    phase 4's blank bias on the 16 fixture requests: one rank's whole batch,
    or with a `mesh` each data rank's block, gathered."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import streaming_greedy_decode
    from tpuasr_torch.parallel import make_sharded_streaming_decode

    cfg = _flagship("float32")
    s = cfg.streaming
    model = _model(torch, cfg, dev, blank_bias)
    feats, flens = fbank_batch(*data["fixture"], cfg.feature, device=dev)
    if mesh is None:
        return streaming_greedy_decode(model, feats, flens, CHUNK, LEFT, cfg.model.blank_id,
                                       s.n_steps)[:2]
    return make_sharded_streaming_decode(model, mesh, "greedy", chunk_size=CHUNK,
                                         num_left_chunks=LEFT, blank_id=cfg.model.blank_id,
                                         n_steps=s.n_steps)(feats, flens)


def _probe_collectives(torch, dev) -> dict:
    """Which collectives this process group takes on tensors on `dev`: each
    is tried once on every rank alike -> {name: "ok" or the error}."""
    import torch.distributed as dist

    n = dist.get_world_size()
    x = torch.arange(4.0, device=dev) + dist.get_rank()
    tries = {
        "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_reduce_min": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MIN),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.arange(4.0 * n, device=dev)),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name in COLLECTIVES:
        try:
            tries[name]()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:  # refused on this device
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _parallel_rank(argv) -> None:
    """A phase 17 rank (`chip_smoke.py --parallel-rank RANK WORLD DIR BACKEND
    DEVICE BLANK_BIAS`): the collectives probe, the four cases' steps and
    the sharded greedy decode with every count reset before and read after,
    its wrappers' calls against its launches (rank 0 also holds each kernel
    against its plain version on the run's inputs), then tp_joint_bench's
    memory analysis; the results into DIR/rank_RANK.pt."""
    import torch
    import torch.distributed as dist

    rank, world, out_dir, backend, device, bias = (int(argv[0]), int(argv[1]), Path(argv[2]),
                                                    argv[3], argv[4], float(argv[5]))
    sys.path.insert(0, str(ROOT))
    from tpuasr_torch.config import Config
    from tpuasr_torch.ops import KERNELS, LAUNCHES, build_all, reset_launch_counts
    from tpuasr_torch.parallel import init_distributed, make_mesh
    from tpuasr_torch.tools.profile_trace import bench_batch
    from tpuasr_torch.tools.tp_joint_bench import analyze

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, dev = init_distributed(device, store_path=str(out_dir / "store"), rank=rank,
                                 world_size=world, backend=backend, timeout_s=PARALLEL_PG_S)
    try:
        if dev.type == "cuda":
            build_all()  # the parent built the libraries: this loads them
        out = {"device": str(dev), "backend": backend}
        out["collectives"] = _probe_collectives(torch, dev) if dev.type == "cuda" else {}
        bench = bench_batch(Config(), dev, BENCH_B, BENCH_FRAMES, BENCH_TOKENS)
        data = _requests()
        meshes = {1: make_mesh(1, dev), PARALLEL_RANKS: make_mesh(PARALLEL_RANKS, dev)}
        sides, parts = {}, {}
        reset_launch_counts()
        with _recording(torch) as seen:  # the parallel run: every count read after it
            for case in PARALLEL_CASES:
                cfg = _parallel_cfg(case)
                sides[case] = _parallel_side(torch, cfg, dev, bench,
                                             meshes[cfg.mesh.model_parallel_size])
                parts[case] = dict(LAUNCHES)
            out["decode"] = [x.cpu() for x in _parallel_decode(torch, dev, data, bias,
                                                                 meshes[1])]
        launches = dict(LAUNCHES)
        before = {}
        for case, name in (("fused", "zero3"), *((c, c) for c in SPLIT_CASES),
                           ("decode", None)):
            now = launches if name is None else parts[name]
            out.setdefault("launches_by_part", {})[case] = {
                k: now[k] - before.get(k, 0) for k in now}
            before = now
        out["launches"] = launches
        calls = {k: sum(c for c, _ in seen.get(k, {}).values()) for k in KERNELS}
        require(all(calls[k] == launches[k] for k in KERNELS),
                f"rank {rank}: wrapper calls on the card {calls} are not the launches "
                f"{ {k: launches[k] for k in KERNELS} }: a call fell back to a plain version")
        out["idle"] = seen.get("idle", {})
        if rank == 0:
            print("kernels against their plain versions on the parallel run's own inputs "
                  "(rank 0):", flush=True)
            out["records"] = _trainer_kernel_records(torch, seen, launches, "parallel",
                                                     timed=1)
        out["sides"] = sides
        if dev.type == "cuda":
            out["tp_memory"] = analyze(meshes[PARALLEL_RANKS], *TP_SHAPE, device=dev)
        torch.save(out, out_dir / f"rank_{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


SCALING_CHIPS, SCALING_HOSTS = 8, (1, 2, 4)  # GPUs a host (a DGX H100's), hosts


def _scaling_table(sides: dict, card: str, step_ms: float, busy_ms: float) -> dict:
    """`parallel.scaling` over rank 0's recorded collectives of each case,
    laid over SCALING_CHIPS GPUs a host at each of SCALING_HOSTS hosts
    (`relayout`: a rank's payloads do not change with the data size; a
    split case, recorded with one data rank, gets the "none" step's
    data-axis collectives, which a dp x tp step adds); efficiency against
    6b's median step (`step_ms`) and its device busy ms, at the assumed
    link rates. The "none" step must have issued two all-reduces: the rows'
    and targets' counts, then the flat gradient with the metrics vector
    (loss, audio seconds, loss_rnnt, loss_ctc)."""
    from tpuasr_torch.parallel.scaling import (
        NIC_GBPS, NVLINK_GBPS, Collective, predict, relayout,
    )

    recs = {case: [Collective(*c) for c in side["collectives"]] for case, side in sides.items()}
    n = sum(g.numel() for g in sides["none"]["grads"])
    got = [(c.op, c.payload) for c in recs["none"]]
    require(got == [("all-reduce", 8), ("all-reduce", 4 * (n + 4))],
            f"17: the none step's collectives {got} are not the counts' all-reduce and one of "
            f"the flat gradient ({n} fp32) with the metrics vector (4 fp32)")
    print(f"17 the none step's gradient all-reduce: {4 * (n + 4)} bytes = the flat gradient "
          f"({n} fp32) + the metrics vector (4 fp32)")
    out = {"card": card, "step_ms": step_ms, "device_busy_ms": busy_ms,
           "nvlink_gbps_assumed": NVLINK_GBPS, "nic_gbps_assumed": NIC_GBPS, "cases": {}}
    print(f"17 scaling prediction ({card}; compute: 6b's median step {step_ms:.1f} ms, its "
          f"device busy {busy_ms:.2f} ms; links ASSUMED: NVLink {NVLINK_GBPS} GB/s a GPU, NICs "
          f"{NIC_GBPS} GB/s a host; {SCALING_CHIPS} GPUs a host). case hosts: ICI MB, DCN MB, "
          f"t_ici + t_dcn ms, efficiency no overlap / full overlap at the step, no overlap at "
          f"the device ms")
    for case, colls in recs.items():
        rows = []
        for hosts in SCALING_HOSTS:
            world = SCALING_CHIPS * hosts
            if case in SPLIT_CASES:
                lay = (relayout(colls, PARALLEL_RANKS, PARALLEL_RANKS, world)
                       + relayout(recs["none"], PARALLEL_RANKS, 1, world, PARALLEL_RANKS))
            else:
                lay = relayout(colls, PARALLEL_RANKS, 1, world)
            row = predict(lay, SCALING_CHIPS, hosts, step_ms)
            row["eff_no_overlap_device_ms"] = predict(lay, SCALING_CHIPS, hosts,
                                                      busy_ms)["eff_no_overlap"]
            rows.append(row)
            print(f"  {case:22s} {hosts}x{SCALING_CHIPS}: {row['ici_mb']:9.2f} "
                  f"{row['dcn_mb']:9.2f} {row['t_ici_ms'] + row['t_dcn_ms']:8.3f}  "
                  f"{row['eff_no_overlap']:7.2%} / {row['eff_full_overlap']:7.2%}  "
                  f"{row['eff_no_overlap_device_ms']:7.2%}")
        out["cases"][case] = {"collectives": len(colls), "payload_bytes":
                              sum(c.payload for c in colls), "rows": rows}
    return out


def _launch_ranks(torch, backend: str, devices: list, blank_bias: float) -> list:
    """Start PARALLEL_RANKS rank processes of this script, wait at most
    PARALLEL_WAIT_S (killing every rank as soon as one fails), print their
    output -> each rank's results."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="parallel-", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        logs = [open(tmp / f"rank_{r}.log", "w+") for r in range(PARALLEL_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(r),
             str(PARALLEL_RANKS), str(tmp), backend, devices[r], repr(blank_bias)],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT) for r in range(PARALLEL_RANKS)]
        deadline = time.monotonic() + PARALLEL_WAIT_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            f.close()
            print(f"--- rank {r} of {PARALLEL_RANKS} ({backend}, {devices[r]}), exit "
                  f"{p.returncode}:\n{text.rstrip()[-6000:]}")
            require(p.returncode == 0, f"phase 17: rank {r} exited {p.returncode}")
        # the ranks' own files: numpy values among the records
        return [torch.load(tmp / f"rank_{r}.pt", weights_only=False)
                for r in range(PARALLEL_RANKS)]


def _parallel_phase(torch, dev, data, bench, blank_bias: float, card: str,
                    step_ms: float, busy_ms: float) -> tuple[dict, dict, dict]:
    """17: 2 ranks on one card over gloo against the 1-rank steps and decode
    on the card, taken first (rank 0 then times its kernels with the card to
    itself, the other rank waiting at a barrier); NCCL across cards where
    there are two; the cost model over the gloo ranks' recorded collectives
    (`card`: the card's name and power limit; `step_ms` / `busy_ms`: 6b's
    median step and its device busy ms); the trainer CLI under torchrun at
    world size 1 (NCCL) beside the one-rank steps. -> (the records, the
    run's launches summed over the ranks, rank 0's kernel records)."""
    import tempfile

    from tpuasr_torch.ops import KERNELS
    from tpuasr_torch.train import GuardedAdam

    n_cards = torch.cuda.device_count()
    runs = {"gloo": ("gloo", ["cuda:0"] * PARALLEL_RANKS)}
    if n_cards >= PARALLEL_RANKS:
        runs["nccl"] = ("nccl", [f"cuda:{r}" for r in range(PARALLEL_RANKS)])
    print(f"17: {n_cards} card(s): 2 ranks on cuda:0 over gloo; NCCL across cards "
          f"{'on cuda:0 and cuda:1' if 'nccl' in runs else 'not run (one card)'}; NCCL at "
          f"world size 1 through the trainer CLI")

    # the trainer under torchrun (NCCL at world size 1) runs beside the
    # one-rank reference steps, which no timing reads, and is awaited before
    # the ranks start (rank 0 times its kernels with the card to itself)
    save_dir = tempfile.TemporaryDirectory(prefix="torchrun-", dir=ROOT / "build")
    t_trainer = time.perf_counter()
    trainer = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "tpuasr_torch.tools.train", "--synthetic", "24", "--epochs", "1",
         "--set", "data.synth_hard=True", f"train.save_dir={save_dir.name}", "train.log_dir=",
         "train.log_every=1"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ref_steps = {case: _parallel_side(torch, _parallel_cfg(case), dev, bench)
                     for case in ("none",) + SPLIT_CASES}
        ref_toks, ref_lens = (x.cpu() for x in _parallel_decode(torch, dev, data, blank_bias))
        stdout, stderr = trainer.communicate(timeout=PARALLEL_WAIT_S)
    finally:
        if trainer.poll() is None:
            trainer.kill()
            trainer.wait()
    trainer_s = time.perf_counter() - t_trainer
    lines = [ln for ln in (stdout + stderr).rstrip().splitlines() if not ln.startswith("{")]
    print(f"17 torchrun trainer (world size 1, {trainer_s:.1f} s beside the one-rank "
          f"reference steps):\n" + "\n".join(lines[-12:]))
    require(trainer.returncode == 0, f"the trainer under torchrun exited {trainer.returncode}")
    require("world size 1 (nccl)" in stdout, "the trainer under torchrun did not take NCCL")
    require((Path(save_dir.name) / "latest").exists(),
            "the torchrun trainer wrote no checkpoint")
    save_dir.cleanup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out, launches, records = {"cards": n_cards}, {}, {}
    for label, (backend, devices) in runs.items():
        t0 = time.perf_counter()
        ranks = _launch_ranks(torch, backend, devices, blank_bias)
        res = out[label] = {"wall_s": time.perf_counter() - t0}
        if backend == "gloo":
            res["collectives_on_cuda"] = ranks[0]["collectives"]
            print(f"17 gloo, collectives on CUDA tensors: {ranks[0]['collectives']}")
            launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
            records = ranks[0]["records"]
            res["scaling"] = _scaling_table(ranks[0]["sides"], card, step_ms, busy_ms)
        for r, rk in enumerate(ranks):
            by_part = {part: {k: v for k, v in c.items() if v and k in KERNELS}
                       for part, c in rk["launches_by_part"].items()}
            print(f"17 {label} rank {r}: launches by part {by_part}; wrapper calls that "
                  f"launched nothing {rk['idle']}")
            for name in KERNELS[:9]:  # #1-#9: fbank .. rnnt_beta_grad
                require(rk["launches_by_part"]["fused"][name] > 0,
                        f"17 rank {r}: the fused-route steps never launched {name}")
            for case in SPLIT_CASES:
                lat = rk["launches_by_part"][case]
                require(lat["rnnt_alpha"] > 0 and lat["rnnt_beta_grad"] > 0
                        and lat["rnnt_fused_fwd"] == lat["rnnt_fused_bwd"] == 0,
                        f"17 rank {r}: the {case} step did not run #8/#9 alone of the "
                        f"RNN-T kernels")
            for case in PARALLEL_CASES:
                cfg = _parallel_cfg(case)
                base = ref_steps[case if case in SPLIT_CASES else "none"]
                res.setdefault(case, []).append(_step_card_vs_cpu(
                    torch, GuardedAdam(cfg.optim), {"card": rk["sides"][case], "cpu": base},
                    f"17 {label} {case}: rank {r} of {PARALLEL_RANKS} ('card') against one "
                    f"rank ('cpu'), both on the card, fp32, bench.py's 12 rows",
                    "fp32 sums of half the rows and a reduction over ranks"
                    + (", the vocabulary's log-softmax across 2 ranks" if case in
                       SPLIT_CASES else "")))
            toks, lens = rk["decode"]
            require(torch.equal(lens, ref_lens) and torch.equal(toks, ref_toks),
                    f"17 {label} rank {r}: sharded streaming greedy differs from one "
                    f"rank's")
        print(f"17 {label}: sharded streaming greedy on the 16 fixture requests identical "
              f"to one rank's on every rank ({int(ref_lens.sum())} tokens)")
        mem = ranks[0].get("tp_memory")
        if mem is not None:
            res["tp_memory"] = mem
            gib = lambda x: x / 2**30
            print(f"17 {label} tp_joint_bench.analyze B{TP_SHAPE[0]} T{TP_SHAPE[1]} U"
                  f"{TP_SHAPE[2]} V{TP_SHAPE[3]} D{TP_SHAPE[4]} fp32 (logits "
                  f"{gib(mem['logits_bytes']):.2f} GiB): peak unsharded (rank 0) "
                  f"{gib(mem['unsharded_peak_bytes_rank0']):.2f} GiB, at tp {mem['tp']} "
                  f"per rank {[round(gib(x), 2) for x in mem['sharded_peak_bytes_per_rank']]}"
                  f" GiB")
            require(max(mem["sharded_peak_bytes_per_rank"])
                    < mem["unsharded_peak_bytes_rank0"],
                    "17: a rank of the split joint peaked above the unsharded one")
    out["torchrun_trainer_s"] = trainer_s
    return out, launches, records


# ---------------------------------------------------------------------------
# phase 18: a JAX-layout checkpoint on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _step_losses(step_home, attr: str):
    """While inside, each step made by the factory `attr` of `step_home`
    records its loss (a host read a step); -> the list, filled as the run
    goes."""
    losses, make = [], getattr(step_home, attr)

    def recording(model, tx, cfg, mesh=None):
        step = make(model, tx, cfg, mesh)

        def run(state, batch, seed):
            state, metrics = step(state, batch, seed)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    setattr(step_home, attr, recording)
    try:
        yield losses
    finally:
        setattr(step_home, attr, make)


def _jax_npz(torch, dev, ckpt: str, out: str) -> dict:
    """The port checkpoint `ckpt` as the JAX package's TrainState tree in
    the npz route's file `out` (with `ckpt`'s info JSON as out.json and its
    train.yaml beside it); restored from `out`, every tensor of the model
    and optimizer state must equal `ckpt`'s bit for bit."""
    import shutil

    from tpuasr_torch.config import load_yaml
    from tpuasr_torch.convert import flax_train_state
    from tpuasr_torch.tools.train import build_model
    from tpuasr_torch.train import TrainState, make_optimizer, restore_checkpoint
    from tpuasr_torch.train.orbax import flatten_tree, read_npz, write_npz

    cfg = load_yaml(str(Path(ckpt).parent / "train.yaml"))

    def restored(path):
        tx = make_optimizer(cfg.optim)
        return restore_checkpoint(path, TrainState.create(build_model(cfg, "online_rnnt", dev),
                                                           tx))

    t0 = time.perf_counter()
    port = restored(ckpt)
    tree = flax_train_state(port)
    write_npz(out, tree)
    shutil.copyfile(ckpt + ".json", out + ".json")
    shutil.copyfile(Path(ckpt).parent / "train.yaml", Path(out).parent / "train.yaml")
    t_write = time.perf_counter() - t0
    leaves = flatten_tree(read_npz(out))
    require(set(leaves) == set(flatten_tree(tree)), "the npz's keys are not the tree's")
    require(any(k.startswith("params/params/encoder/block") for k in leaves)
            and any(k.startswith("opt_state/nu_max/") for k in leaves),
            "the npz is not a JAX TrainState tree (unrolled blocks, amsgrad moments)")
    t0 = time.perf_counter()
    jax = restored(out)
    t_read = time.perf_counter() - t0
    a, b = port.model.state_dict(), jax.model.state_dict()
    require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
            "the npz's model differs from the port checkpoint's")
    for k in ("count", "mu", "nu", "nu_max"):
        x, y = getattr(port.opt_state, k), getattr(jax.opt_state, k)
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"the npz's optimizer state {k} differs from the port checkpoint's")
    require((port.step, port.lr_scale, int(port.skipped)) == (jax.step, jax.lr_scale,
                                                             int(jax.skipped)),
            "the npz's step, lr_scale or skipped differ from the port checkpoint's")
    size = Path(out).stat().st_size
    print(f"phase 8's checkpoint as a JAX TrainState npz: {len(leaves)} arrays, {size / 2**20:.1f} "
          f"MiB, written in {t_write:.1f} s (the port checkpoint's restore included), restored in "
          f"{t_read:.1f} s; model ({len(a)} tensors) and optimizer state (count, mu, nu, nu_max; "
          f"{port.opt_state.mu.numel()} entries each), step {jax.step}, lr_scale "
          f"{jax.lr_scale}, skipped {int(jax.skipped)}: identical to the port checkpoint's")
    return {"arrays": len(leaves), "bytes": size, "write_s": t_write, "restore_s": t_read,
            "step": jax.step}


def _cli_lines(cli, argv) -> tuple:
    """(cli.main(argv), its printed lines but the effective-config one)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(argv)
    return res, [ln for ln in buf.getvalue().splitlines()
                 if not ln.startswith("effective config")]


def _jax_checkpoint_phase(torch, dev, save_dir: str, corpus: str, bench_kernels) -> dict:
    """Phase 18 (see the module's docstring). `save_dir`: phase 8's, `corpus`:
    phase 9's root, `bench_kernels`: the port kernels 6b's profiled step
    ran."""
    import io
    import tempfile

    from tpuasr_torch.ops import KERNELS, LAUNCHES
    from tpuasr_torch.tools import (
        batch_sweep, campaign_eval, eval_streaming, evaluate, profile_step, profile_trace,
    )
    from tpuasr_torch.tools import train as train_tool
    from tpuasr_torch.train import latest_path, load_info
    from tpuasr_torch.train import loop as train_loop_mod

    out, walls = {}, {}
    ckpt = latest_path(save_dir)
    with tempfile.TemporaryDirectory(prefix="jax-", dir=ROOT / "build") as work:
        npz = f"{work}/ckpt/latest.npz"
        t0 = time.perf_counter()
        out["npz"] = _jax_npz(torch, dev, ckpt, npz)
        walls["npz"] = time.perf_counter() - t0

        # evaluate and eval_streaming on phase 9's corpus: the npz against the port's file
        split = f"{corpus}/split"
        data = [f"data.{s}_{k}={split}/{s}/{f}" for s in ("train", "dev", "test")
                for k, f in (("wav_scp", "wav.scp"), ("text", "pinyin"))]
        data.append(f"data.vocab_file={corpus}/vocab.txt")
        common = ["--data_root", corpus, "--max_samples", "16", "--set", *data]
        for label, cli, extra in (("evaluate rnnt_greedy", evaluate,
                                   ["--workload", "online_rnnt", "--mode", "rnnt_greedy"]),
                                  ("eval_streaming", eval_streaming, [])):
            t0 = time.perf_counter()
            r_port, l_port = _cli_lines(cli, ["--checkpoint", ckpt, *extra, *common])
            r_jax, l_jax = _cli_lines(cli, ["--checkpoint", npz, *extra, *common])
            walls[label] = time.perf_counter() - t0
            require(l_port == l_jax and r_port.samples == r_jax.samples and len(l_jax) > 3,
                    f"{label}: the npz's output differs from the port checkpoint's")
            print(f"{label} on phase 9's corpus, given the npz and given the port checkpoint: "
                  f"the same {len(l_jax)} lines ({len(r_jax.samples)} utterances); "
                  f"{l_jax[0]}")
            out[label] = l_jax[:3]

        # every decode mode over the npz
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            swept = campaign_eval.main([npz, "32"])
        walls["campaign_eval"] = time.perf_counter() - t0
        cers = [ln for ln in buf.getvalue().splitlines() if "CER" in ln or "=====" in ln]
        require(len(swept) == 9 and all(r is not None for r in swept),
                "campaign_eval over the npz did not run its 9 modes")
        print(f"campaign_eval over the npz (4 held-out and 4 held-in utterances a mode, "
              f"{walls['campaign_eval']:.1f} s): exit 0; " + " | ".join(cers[-4:]))
        out["campaign_eval"] = cers

        # one epoch resumed from each, into its own save dir
        info = load_info(ckpt)
        firsts, results = {}, {}
        for side, path in (("port", ckpt), ("npz", npz)):
            t0 = time.perf_counter()
            with _step_losses(train_loop_mod, "make_train_step") as losses, \
                    contextlib.redirect_stdout(io.StringIO()):
                res = train_tool.main(["--workload", "online_rnnt", "--synthetic", "48",
                                       "--epochs", str(info["epoch"] + 2), "--resume", path,
                                       "--set", f"train.save_dir={work}/resumed_{side}"])
            walls[f"resume {side}"] = time.perf_counter() - t0
            after = load_info(latest_path(f"{work}/resumed_{side}"))
            require(len(res.train_losses) == 1 and after["epoch"] == info["epoch"] + 1
                    and res.state.step == info["step"] + len(losses),
                    f"the run resumed from the {side} checkpoint did not continue at epoch "
                    f"{info['epoch'] + 1}, step {info['step']}: {after}, {len(losses)} steps")
            firsts[side], results[side] = losses[0], res
        rel = abs(firsts["npz"] - firsts["port"]) / abs(firsts["port"])
        require(rel <= 1e-4, f"the first resumed step's loss: npz {firsts['npz']}, port "
                             f"checkpoint {firsts['port']} ({rel:.2e} relative, over 1e-4)")
        print(f"train --resume for one epoch (epoch {info['epoch'] + 1} from step "
              f"{info['step']}): first-step loss npz {firsts['npz']:.6f}, port checkpoint "
              f"{firsts['port']:.6f} ({rel:.2e} relative); epoch train loss "
              f"{results['npz'].train_losses[0]:.4f} / {results['port'].train_losses[0]:.4f}")
        out["resume"] = {"first_loss": firsts, "rel": rel, "epoch": info["epoch"] + 1,
                         "from_step": info["step"]}

        # the profiling tools at bench.py's configuration
        t0 = time.perf_counter()
        out["profile_step_ms"] = {k: v * 1e3 for k, v in profile_step.main(["--iters", "5"])
                                  .items()}
        walls["profile_step"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["batch_sweep"] = batch_sweep.main(["--batches", "12", "24", "--steps", "10"])
        walls["batch_sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        before = dict(LAUNCHES)
        report = profile_trace.main(["--out", f"{work}/trace", "--steps", "5", "--fused"])
        walls["profile_trace"] = time.perf_counter() - t0
        traced = {k: LAUNCHES[k] - before[k] for k in KERNELS}
        require(report is not None, "profile_trace's trace holds no device event")
        missing = sorted(set(bench_kernels) - set(report["families"]))
        require(not missing, f"profile_trace's trace lacks the hand kernels {missing} that "
                             f"6b's step ran")
        for name in ("fbank", "relpos_attention", "relpos_attention_bwd", "rnnt_fused_fwd",
                     "rnnt_fused_bwd", "ctc_alpha", "ctc_beta_grad", "rnnt_alpha",
                     "rnnt_beta_grad"):
            require(traced[name] >= 6, f"profile_trace's 6 steps launched {name} "
                                       f"{traced[name]} times")
        out["profile_trace"] = {"device_ms_per_step": report["ms_per_step"],
                                "launches": traced, "hand_kernels": sorted(bench_kernels)}
    out["walls_s"] = walls
    print("phase 18 walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a phase 17 rank, started by main()
        try:
            _parallel_rank(sys.argv[2:])
        except SmokeFailure as e:
            print(f"chip_smoke rank: FAILED: {e}", file=sys.stderr)
            sys.exit(1)
        sys.exit(0)
    try:
        device = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}))
