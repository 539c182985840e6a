#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printed on its own line:
  1. build   — nvcc builds the kernel library from wav2vec_s_tpu_torch/csrc
               (one nvcc per source, all started together) and prints each
               kernel's registers and spills as ptxas reports them;
  2. kernel  — the chunk-attention kernels (K1) against their plain twin at
               the main-path shapes (128 streams, 12 heads of 64, kv_cap 512,
               R 48 and 240, several t0; float32 on the CUDA-core kernel,
               bfloat16 on the tensor-core kernel, each case prints its set),
               then the tensor-core kernel at heads of 32 and 128, R 24, one
               stream, and t0 at the edges of its 64-key tiles (0, 1, 63, 64,
               65, 480, kv_cap); then kernel, twin and library call timed
               over the 15 calls of a 10-s ds2 stream at 128 streams and at
               8: device time under a CUDA graph, the eager time and the
               wrapper's host time beside it; then the kernel alone at one
               stream, at R 240 and at t0 0 and 448;
  2b. decode attention — the emission loop's one-query attention (K7)
               against its plain version, bfloat16, at the main-path shapes:
               the serving jointer [1024, 256, 768] and [1024, 256, 1024]
               under a serving-like plane and slot extents, the decoders'
               jointer [512, 128, 768] at visible 40, 256 and 512, the LM
               [257, 256, 768 | 1024] to index + 1, the decoders' LM
               [61, 128, 768] to index + 1; heads of 6 in float32
               and bfloat16 (the fallback loads); then the jointer's f32
               log-probs through K7 against the plain version's at Base and
               Large (serving) and Base (decoder): within twice the plain
               bf16 version's own distance from a float32 run of the same
               inputs, tokens equal wherever the top two differ by more
               than that; that a replayed chunk of both decoders runs
               (jointer + LM layers) x max_emit K7 kernels (torch.profiler)
               and their eager loop and every serving step launch as many;
               each shape timed under a CUDA graph beside its byte bound
               (the visible rows' K and V, the plane's bytes of the range),
               the plain version and scaled_dot_product_attention under the
               boolean mask of the visible rows, with the wrapper's host
               time a call;
  3. flash   — the block-sparse flash-attention kernel (K2) against its
               plain twin at the one-shot encoder's full-width call (32
               streams, T 488, mc 16, rc 8 -> S 728, 12 heads of 64, float32
               and bfloat16, padded keys; and an rc 0 layout): output on
               valid rows and the row stats m/l; float32 runs the CUDA-core
               kernel, bfloat16 the tensor-core kernel (each case prints its
               set); the same at the Large seq2seq call's encoder (phase
               17c: B 2, T 500, 16 heads of 64, bfloat16); then kernel,
               twin and library call timed per call;
  3b. flash backward — the flash backward kernels (K3) against their plain
               twin at the training call (8 streams, T 500 -> S 748, mc 16,
               rc 8, 12 heads of 64, padded keys; and an rc 0 layout; float32
               and bfloat16; dropout 0 and 0.1): dQ on valid rows, dK, dV;
               the forward with dropout against its twin; two runs
               bit-identical; a data-parallel shard (rows 3: of 8 with
               dropout_row0 3) equal to the whole batch's rows bit for bit;
               float32 on the CUDA-core kernels, bfloat16 on
               the tensor-core kernels; the same in bfloat16 at the Base
               seq2seq microbatch (B 4) and the Large one (B 2, 16 heads of
               64 over 1024) of phase 17; then kernel, twin and the library
               call (its backward alone: forward + backward minus forward)
               timed;
  3c. flash pretrain — K2, then K3 at dropout 0 and 0.1, against their
               twins at the pre-training call (B 5, T 628: a 200960-sample
               crop; 12 heads of 64, padded keys) under each of the 7
               context buckets (8,4) .. (32,16) (S 876-940), bfloat16 on
               the tensor-core kernels, float32 on the CUDA-core kernels;
               then per bucket K2 and K3 (bf16, dropout 0.1) timed beside
               their bounds and library calls;
  4. dropout — the counter-based dropout kernel (K4) against its twin:
               bit-equal outputs and masks at the CAAT training step's
               shapes ([8*748, 768], [8*748, 3072], the attention
               probabilities [8*12*748, 748]) and the pre-training step's
               (dropout_input [5*627, 768], dropout_features [5*627, 512],
               the FFN rows [5*628, 3072], the dense attention
               probabilities [5*12*940, 940]), float32 and bfloat16,
               p 0.1 and 0.3; keep
               share within 4 sigma, forward mask == backward mask, new
               seed / offset -> new mask; shards (a data-parallel rank's
               rows, a context-parallel rank's time block: a non-zero index
               base and unequal spans, and both) bit-equal to the twin
               under the same index map and to the matching part of the
               whole tensor's mask; then both timed per call;
  5. lattice — the transducer kernels (K5a alphas, K5b betas, K6 affine
               rows forward and reverse) and the two fused walks (alphas +
               expected delay, betas + its backward) against their row-scan
               twins at [8, 8, 41], [16, 32, 65], [4, 512, 129] (the warp
               set) and [2, 8, 300], [2, 64, 300] (the block set, past U
               256) with ragged lengths, every launch on the set that
               kernels.lattice_path picks; each kernel alone against a
               float64 run of its twin beside the f32 twin's own error, and
               the block set's unfused sequence (alphas, coefficients from
               the stored alpha, rows: what the loss ran past U 256 before
               the block set had fused walks) beside its fused walks; then
               the delay-transducer loss
               and d/dacts through the kernels against float64 twins; at the
               first two shapes and at [2, 8, 300] each kernel's and walk's
               device time alone
               (50 launches in one CUDA graph, inputs and lengths prepared
               outside) beside the block set's (its C entry points), the
               wrappers' host
               times on either set, the twin, and the bound: the larger of
               the byte bound and T + U - 1 dependent steps times the least
               step of the recursion that the probe kernel
               wav2vec_s_tpu_torch/tools/lattice_step_probe.cu measures
               (built here into a library of its own): column heads in
               registers passed by warp shuffle at one cell per lane and at
               the warp set's columns per lane, and the block set's step
               (shared memory + barrier); it also times one dependent global
               load, printed beside K6; the loss's forward + backward time
               and its device kernels (torch.profiler, by name) on either
               set;
  6. parity  — a tiny model decoded on the card equals the same decode on
               the CPU (plain twins), texts and delays;
  7. one-shot parity — the tiny one-shot decode (flash attention) on the
               card equals the one on the CPU and the cached decode on the
               card;
  7b. beam parity — the tiny model under the four batched beam decoders
               (beam 3, mixed lengths; the incremental encoder for the
               streaming ones, flash attention for the one-shot ones): each
               decode on the card equals the same decode on the CPU, texts
               and delays; the batched decoder equals the host searcher, both
               on the card; argmax and the stable sorts take the lowest
               index among equals on the card; and whether the fused
               one-shot texts equal the fused streaming texts in bfloat16
               (they do in float32: the encoders differ by rounding);
  7c. serving parity — the tiny model, float32: ServingSession (4 streams
               on 2 slots: staggered joins, a stall, recycling, a compaction)
               on the card equals it on the CPU and the cached decoder on
               the card run alone on each stream, texts and delays exactly;
  8. train parity — tiny CAAT fine-tuning, dropout off: two updates on the
               card (kernels) equal the CPU's (twins): loss, grad norm,
               every parameter; then a 30-step overfit with the recipe's
               dropouts, whose loss must fall;
  8b. train flash parity — the same two updates with
               attention_impl="flash" (K2 with row stats and K3 in every
               layer) on the card equal the CPU's; then, with the recipe's
               dropouts on, flash equals dense on the card under one seed;
  8c. pretrain parity — tiny wav2vec-S pre-training (hop 20, 2 layers 32
               wide), float32, dropout off: two updates on the card equal the
               CPU's (loss, grad norm, every parameter), dense and flash,
               every draw (negatives, Gumbel uniforms) from one CPU
               generator per update; then, the recipe's dropouts on, flash
               equals dense on the card under one seed;
  9. full    — wav2vec-S Base + CAAT base, bfloat16, random weights from a
               seed, DECISION_STEP=2, max_emit 4, int16 wire: the cached
               agent on 128 streams of 10 s per corpus, one warm-up corpus,
               then CORPORA timed ones; K1's launch count must equal
               layers x chunks x corpora, all of them on the tensor-core
               kernel; K7's, read from one more corpus under torch.profiler
               (the loop replays CUDA graphs), (jointer + LM layers) x
               max_emit x chunks a corpus;
  10. one-shot full — the same model with attention_impl="flash", the
               one-shot corpus decoder on 256 streams of 10 s, encode batch
               32: one warm-up corpus, then CORPORA timed ones; K2's launch
               count must equal layers x sub-batches x corpora, all of them
               on the tensor-core kernel; K7's as in phase 9;
  10b. beam full — the beam quality path at the same width: bfloat16,
               64 streams of 10 s, beam 5, inter_beam 1, max_steps 8, max_len
               64, eager emission, DECISION_STEP=2, int16 wire, corpus k+1
               staged before corpus k is waited for.
               FusedBeamStreamingDecoder (dense model): K1 launches == layers
               x chunks x corpora, all on the tensor-core kernel, K2 none.
               FusedOneShotBeamDecoder (attention_impl="flash"): K2 launches
               == layers x sub-batches x corpora, all on the tensor-core
               kernel, K1 none.  For each: audio-sec/s per corpus, peak
               memory, beam iterations run, the reads from the device that
               one decode of a staged corpus makes with the early-stop read
               off (counted with torch.cuda.set_sync_debug_mode at two
               corpus lengths: the count must not grow with the number of
               chunks), some text emitted; the share of streams whose fused
               one-shot text equals the fused streaming text; and the
               streaming decoder timed with the early-stop read off, every
               iteration and every fourth;
  11. train full — the CAAT fine-tuning step at Base + CAAT base width,
               bfloat16, dense attention, the recipe's dropouts on, B 8 x
               10 s of seeded noise, U 40: one warm step, then two windows
               of 5 steps; K4 launches must equal the dropout sites, the
               lattice launches two forward fused walks and one reverse
               walk per loss chunk on the warp set and no single recursion,
               K1/K2 none; finite loss and grad norm, no skipped step; then
               one step on targets of 299 labels (U + 1 = 300, past the
               warp set), whose loss runs the block set's fused walks;
  12. cli full — the training entry point, wav2vec_s_tpu_torch.train.cli
               main(), at the same width on seeded-noise wavs (16 x 10 s), a
               tsv and a 10000-entry dict written to a temp dir: bfloat16,
               attention_impl="flash", the recipe's dropouts, batches of 8,
               2 warm updates then 10 timed ones, the final checkpoint; a
               second call resumes from it and takes 2 more updates; then
               the same 12 updates on dense attention through the same entry
               point, beside it.  K2 launches == K3 launches == encoder
               layers kept by layerdrop, every one on the tensor-core
               kernels, K4 and the fused walks as in phase 11 (the attention
               sites launch no K4), K1 none; finite losses, no skipped
               step.
  13. eval cli — the eval entry point, wav2vec_s_tpu_torch.eval.cli main(),
               at the same width (bf16, random weights from seed 0 saved once
               through checkpoint/io.py) with dot-overrides alone, on 64
               seeded-noise wavs of 10 s: batch-decode --decoder cached
               (batches of 32: K1 == layers x chunks x batches), oneshot
               under flash (K2 == layers x sub-batches), stream-beam (K1 ==
               layers x chunks), sweep --steps 2,4; every launch on the
               tensor-core kernels, the CLI's texts and delays equal to the
               decoder's decode_corpus on the same batches; simul on 2 wavs
               of 4 s under flash (K2 in every prefix encode); score on the
               cached run's texts;
  14. serving full — ServingSession at the same width, bf16: 16 slots,
               t_cap 1024, 48 streams of seeded lengths between 2 and 10 s
               admitted as slots free up, 640 ms pushed per stream per step,
               a seeded quarter stalling one step in four: every stream
               finishes, delays rise and stay within the stream plus one
               window, compaction runs; steps, compactions, the share of
               streams equal to the cached decoder's, wall per step p50/p99,
               audio-sec/s, device kernels of one step, peak memory; K7's
               launches must equal steps x max_emit x (jointer + LM layers)
               + the LM layers of each step that resets a slot, and in the
               profiled step the wrapper's count equals the card's.
  15. pretrain full — wav2vec-S streaming pre-training through the
               training entry point with configs/pretrain_base.yaml and
               dot-overrides (Base width, bf16, sampled contexts, the
               recipe's dropouts and layerdrop) on 20 seeded-noise wavs of
               250000 samples (B 5 in the 200960-sample bucket): 2 warm +
               10 timed updates, dense then attention_impl=flash; K4 ==
               twice the dropout sites (less the attention sites under
               flash), K2 == K3 == encoder layers kept, all on the
               tensor-core kernels, K1 none; at least 3 distinct (mc, rc)
               buckets; finite losses, no skipped update; updates/s, peak
               memory, the buckets, the host ms of each update's draws, the
               tile-table rebuilds.  Then the chain: the flash run's
               checkpoint -> convert_cli export to a fairseq .pt -> the
               port's import (equal to the saved state dict key for key) ->
               a CAAT train.cli call with run.w2v2_model_path whose encoder
               equals the pre-trained one before its first update, and
               which takes one update.
  16. parallel — (a) two ranks on the one card over gloo (2 processes on
               cuda:0, each with 4 of the 8 rows), the port's data-parallel
               step at Base + CAAT base width, flash attention, every
               dropout on: two updates against one process over the 8
               rows (float32, bfloat16, bfloat16 under ZeRO-1): loss and
               grad norm within DDP_TOL; against one process that runs the
               same split of rows (0-3, then 4-7, gradients summed) within
               DDP_SPLIT_TOL; Adam's first moments and the parameters no
               further from the one over 8 rows than that process is (twice
               it, plus DDP_FLOOR); K2, K3, K4 and the lattice walks
               launched on each rank; the plan's all-reduce of one update's
               gradients timed; ZeRO-1's optimizer moments per rank (about
               half).  (b) the training entry point under
               python -m torch.distributed.run with one rank on nccl: one
               launch that runs data parallelism, then run.zero=true, then
               run.fsdp=true in that rank, on configs/pretrain_base.yaml at
               phase 15's shapes, 3 updates, each against the same call
               without a process group (in this process): the same updates
               and skips, losses rtol 1e-5, grad norms rtol 1e-4,
               parameters within 1e-2 x lr.
  17. asr    — the offline-ASR family (models/asr.py, eval/generator.py).
               (a) Tiny CTC (also with a row whose labels cannot fit its
               frames: optax's finite floor) and seq2seq recipes, dense and
               flash, float32: loss (rtol 1e-5) and every gradient (|diff|
               <= 1e-4 |g| + 1e-5 max |g|; F.ctc_loss's backward is not
               deterministic on the card) against the CPU; the three greedy
               decoders (flash encode) and Seq2SeqBeamGenerator: the same
               ids (tools/asr_parity.py, shared with the card tests).
               (b) The training entry point on
               configs/ctc_asr_base.yaml (letter dict, char tokenizer,
               run.eval_wer) and configs/offline_asr_base.yaml (a
               10000-entry word dict, word tokenizer, run.eval_bleu) at
               Base width, bf16, the recipes' dropouts, B 8 x 10 s
               (data.max_tokens 1280000), 2 warm + 10 timed updates and one
               validation of 8 wavs, dense then flash: K3 == encoder layers
               kept, K2 == K3 + 2 x 12 (the validation's loss forward and
               the decode's encode), K4 > 0, all on the tensor-core
               kernels; finite losses and metrics; updates/s, peak memory.
               (c) configs/offline_asr_large.yaml (24 x 1024 encoder, 12 x
               1024 decoder), flash, B 4, 2 updates: K2 == K3 == layers
               kept, peak memory.  (d) eval.cli ctc-decode on (b)'s flash
               CTC checkpoint, 64 wavs, and eval.cli generate on phase 13's
               CAAT checkpoint (written again), 8 wavs, each call cold,
               flash encode: K2 a multiple of 12, audio-sec/s.  Then K4
               against its twin (bit-equal outputs and masks, forward mask
               == backward mask) at every (shape, dtype, rate) that the
               training calls of (b) and (c) dropped.
  18. families — the fbank and text CAAT families (models/fbank.py,
               models/text_caat.py, stream/fbank_engine.py).  (a) Tiny, float32,
               the recipe's dropouts on: every fbank front-end x jointer and
               the text model, loss (rtol 1e-5) and every gradient (|diff|
               <= 1e-4 |g| + 1e-5 max |g|) on the card against the CPU; the
               fbank agent's texts and delays equal
               (tools/family_parity.py, shared with the card tests).  (b)
               The training entry point on configs/caat_simulasr_base.yaml
               with data.features=fbank, shallow2d + mha, the word tokenizer,
               a 10000-entry dict, run.w2v2_model_path naming no file (the
               family ignores it): Base + CAAT base, bf16, B 8 x 10 s (1008
               log-mel frames), 2 warm + 10 timed updates and one validation
               of 8 wavs with its greedy decode; then one update at full
               width for each other front-end (vgg2d, resnet, resnet_small)
               and jointer (concat, attention), peak memory each.  (c) The
               same entry point with data.features=text: 64 seeded pairs
               (sources of 58-61 tokens, targets of 21-61), B 16, 2 warm +
               10 timed updates.  K4 and the warp set's two fused walks in
               every update, K1 / K2 / K3 none (the families' encoders run
               the dense block bias); updates/s, peak memory, K4 and walk
               launches per update.  (d) eval.cli simul on (b)'s checkpoint,
               2 streams of 4 s: AL, audio-sec/s.  Then K4 against its twin
               at every (shape, dtype, rate) that (b) and (c) dropped.
  19. full context and baselines — the group-norm front-end, the
               full-context wav2vec 2.0 encoder (models/wav2vec2.py) and the
               wait-k and MMA baselines (models/waitk.py, models/mma.py,
               stream/mma_agent.py).  (a) Tiny, float32, on the card
               against the CPU (tools/baseline_parity.py, shared with the
               card tests): the group-norm model on the full-context and
               the blockwise encoder (extract_features; the pre-training
               loss and every gradient); wait-k and MMA training loss and
               every gradient, dense and flash, the recipe's dropouts (MMA
               without and with its energy noise); hard_decode_step; the
               two agents' words and delays.  (b) A stock-layout wav2vec
               2.0 Base .pt (weight_g / weight_v conv positions, the block-0
               group norm) made from a seed through the port's export;
               convert_cli --encoder-type full: the imported parameters
               equal the model's, the exported .pt equals the input; the
               full-context extract_features at B 8 x 10 s, bf16: ms per
               call, peak memory; then continued pre-training through the
               training entry point (configs/pretrain_base.yaml,
               model.extractor_mode=default, run.load_pretrained_model_from
               that .pt, flash): the model before its first update equals
               the .pt's weights (conv positions dropped), 2 warm + 10
               timed updates, K2 == K3 == layers kept, updates/s, peak
               memory.  (c) wait-k (k 3, stride 8) and MMA on the
               wav2vec-S Base encoder (flash) and CAAT-base decoder widths,
               bf16, B 8 x 10 s, U 40, 1 warm + 4 timed updates by hand
               (token NLL; MMA plus 0.1 latency_loss, energy noise on; an
               update whose loss is not finite is skipped, and the layer-0
               alignment mass per step printed): updates/s, peak
               memory, K2 == K3 == layers kept, K4 > 0; WaitkAgent and
               MMAStreamingAgent under SimulEvaluator on 2 streams of 4 s:
               audio-sec/s, AL, K2 launches per model call.  Then K4
               against its twin at every (shape, dtype, rate) that (b) and
               (c) dropped.
  20. parallel more, prep and debug — (a) the CAAT step by hand at phase
               16a's shapes (Base + CAAT base, flash, the recipe's
               dropouts, B 8 x 10 s, U 40, two updates) under tensor
               parallelism, ranks on cuda:0 over gloo: data 1 x model 2 in
               float32 and bfloat16, data 2 x model 2 with FSDP and with
               ZeRO-1 in bfloat16, against phase 16a's one process: loss
               and grad norm within DDP_TOL, the parameters (and, in
               bfloat16, Adam's first moments) no further than phase 16a's
               yardsticks; per rank the update times, peak memory and the
               K2/K3/K4/walk launches; K2 and K3 with a head base (heads
               6-11 of 12 on rows 4: of 8) equal to the whole call's heads
               and rows bit for bit and to their twins, then timed at one
               rank's call (6 heads) beside bound, twin and library call;
               K4 against its twin at every (shape, dtype, rate, index map)
               the ranks dropped.  (b) The training entry point on 4 ranks
               (data 2 x seq 2) with run.seq=2 and run.zero=true, then
               run.fsdp=true, dense attention, bf16, 3 updates, against
               run.seq=1 on the same ranks (data 4, the same 8-row
               batches): losses and grad norms within DDP_TOL (bfloat16).
               (c) The Base encoder's 12 layers (flash, bf16 activations,
               dropouts 0) pipelined over 2 stages with 8 microbatches of
               B 8 x 10 s (parallel/pipeline.py): the loss and every
               layer's gradient against apply_stacked in one process over
               the same microbatches (PIPE_TOL); K2 == K3 == 6 x 8 per
               stage.  (d) A seeded LibriSpeech-layout tree of 16 wavs of
               10 s -> prep librispeech -> prep s2t -> preprocess; the
               training entry point on those files, 12 updates, flash,
               bf16, with run.profile_dir and run.debug_nan: the trace of
               updates 11-12 names K2's and K4's kernels among its CUDA
               kernels; a NaN planted in one parameter of the checkpoint:
               the next update raises FloatingPointError naming it.
  21. remat, flat optimizer, reader — (a) the CAAT Large widths (1024, 16
               heads, FFN 4096) cut to 4 encoder and 2 + 2 decoder and
               jointer layers, bf16, flash, the recipe's dropouts, B 4 x 10
               s, U 40, 3 updates by hand under run.remat none, dots,
               nothing, offload_dots, remat_extractor alone and with
               nothing, the flat Adam, and the flat Adafactor against the
               tree Adafactor over the vector raveled every update: each
               against its reference, losses rtol 1e-5, grad norms 1e-4,
               parameters within 1e-2 x lr, the same skips, the update
               generator in the same state; a recompute launches K2 twice
               and K3 once per kept layer and K4 once more per forward K4
               site, the forward's and the recompute's contexts alike.
               (b) The training entry point on
               configs/caat_simulasr_large.yaml at full depth and width
               (24 x 1024 encoder, 12 + 12 x 1024 decoder and jointer),
               data.max_tokens 1440000 (8 of 9 x 10 s in 2 microbatches),
               bf16, flash, the word tokenizer, 2 updates per call: no
               switch, run.remat=dots, nothing + remat_extractor,
               offload_dots, then run.flat_optimizer: peak memory, the
               second update's seconds, K2/K3/K4/walk launches (the final
               checkpoint is not written); then Adam's update alone over
               the recipe's parameters, tree against flat, in turns.  (c) The native batched reader
               against the per-file reader on 9 PCM16 wavs of 10 s and a
               stereo one, bit for bit; an 8 kHz file; the Large batch's
               collate with either reader, in turns.
Each phase prints its wall seconds ("phase clock"), and the whole script's
before the card line.  Each of the full paths runs with every launch count set to 0 just before
it and read just after.  Beside each kernel's time stands its bound (the
least time the card could take: bytes over 3.35 TB/s or operations over the
peak rate of their type, whichever is larger; for the lattice recursions
the latency of their dependent steps where that is larger still) and, where
one PyTorch call
computes the same function, that call's time (timed here, used nowhere in
the package).  Then the card (nvidia-smi name, power
limit), the kernel summary as JSON, and the result line.  Any failure
raises: no result line, non-zero exit.  Without a CUDA device it exits 2
at once.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

CORPORA = 3
N_STREAMS = 128
ONESHOT_STREAMS = 256
ENCODE_BATCH = 32
SECONDS = 10.0


def _counters():
    from wav2vec_s_tpu_torch.ops.chunk_attention import chunk_cache_attention
    from wav2vec_s_tpu_torch.ops.decode_attention import decode_attention
    from wav2vec_s_tpu_torch.ops.dropout import hw_dropout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_bwd, blockwise_flash_attention_packed)
    from wav2vec_s_tpu_torch.ops.transducer import kernels

    return {"chunk_cache_attention": chunk_cache_attention,
            "blockwise_flash_attention_packed":
                blockwise_flash_attention_packed,
            "blockwise_flash_attention_bwd": blockwise_flash_attention_bwd,
            "hw_dropout": hw_dropout,
            "transducer_forward_walk": kernels.alphas_and_expected_delay,
            "transducer_reverse_walk": kernels.betas_and_expected_delay_bwd,
            "transducer_alphas": kernels.alphas,
            "transducer_betas": kernels.betas,
            "transducer_affine_rows": kernels.affine_rows,
            # eager launches only: a CUDA graph's replays pass no wrapper
            # (the decoders' emission loops: _k7_per_corpus)
            "decode_attention": decode_attention}


def _set_wrappers():
    """The wrappers with two kernel sets: tensor cores and CUDA cores (K1,
    K2, K3), the warp set and the block set (K5a, K5b, K6)."""
    from wav2vec_s_tpu_torch.ops.chunk_attention import chunk_cache_attention
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_bwd, blockwise_flash_attention_packed)
    from wav2vec_s_tpu_torch.ops.transducer import kernels

    return {"K1": chunk_cache_attention,
            "K2": blockwise_flash_attention_packed,
            "K3": blockwise_flash_attention_bwd,
            "K5a": kernels.alphas, "K5b": kernels.betas,
            "K6": kernels.affine_rows}


# the fused lattice walks, counted per kernel set: "<name>" on the warp
# set (csrc/transducer_warp.cu), "<name>_block" on the block set
# (csrc/transducer.cu)
WALKS = ("transducer_forward_walk", "transducer_reverse_walk")


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "path_launches"):
            fn.path_launches = dict.fromkeys(fn.path_launches, 0)


def _counts():
    counters = _counters()
    out = {name: fn.launches for name, fn in counters.items()}
    for name in WALKS:
        out[name] = counters[name].path_launches["warp"]
        out[name + "_block"] = counters[name].path_launches["block"]
    return out


def _set_paths():
    """{K1 | K2 | K3 | K5a | K5b | K6: launches of the wrapper on each
    kernel set}."""
    return {k: dict(fn.path_launches) for k, fn in _set_wrappers().items()}


def _on_tensor_cores(paths, want):
    """Every launch of a bfloat16 full-width path ran on the tensor-core
    kernels: ``want`` = {K1 | K2 | K3: launches}."""
    for name, n in want.items():
        assert paths[name] == {"tensor_core": n, "cuda_core": 0}, (
            name, paths[name], n)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


# NVIDIA's data sheet for the H100 SXM: device memory rate, dense bf16
# tensor-core rate, float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _bound(n_bytes, flops, dtype):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``n_bytes`` (each input read once, each output written
    once) and do ``flops`` operations on inputs of ``dtype``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _cuda_ms(fn, reps):
    import torch

    fn()                                      # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, calls, reps=5):
    """Host time per call of a wrapper: the clock around ``fn`` (``calls``
    eager calls, nothing read back), the device drained before and after."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    torch.cuda.synchronize()
    return best * 1e3 / calls


def _row(err, ms, plain_ms, bound, library_ms):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


K1_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def phase_kernel():
    """K1 vs twin at main-path shapes and at the edges of the tensor-core
    kernel's tiling -> the kernel's row (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms)."""
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops.chunk_attention import (
        chunk_cache_attention, chunk_cache_attention_ref, kernel_path)
    from wav2vec_s_tpu_torch.stream.incremental import chunk_layout
    from wav2vec_s_tpu_torch.tools.timing import graph_ms

    kv_cap = 512
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(dtype, *shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def inputs(B, R, D, dtype):
        return (rand(dtype, B, R, D) * 0.125, rand(dtype, kv_cap, B, D),
                rand(dtype, kv_cap, B, D), rand(dtype, B, R, D),
                rand(dtype, B, R, D))

    def bias_of(blocks):                 # R = 24 (ds1), 48 (ds2), 240 (ds10)
        return torch.as_tensor(chunk_layout(16, 8, blocks)[1], device=dev)

    # (streams, heads, head width, dtype, blocks per step, t0s): the main
    # path's widths in both dtypes; then the tensor-core kernel at its other
    # head widths, at one stream, and at the edges of its 64-key tiles
    edges = (0, 1, 63, 64, 65, 480, kv_cap)
    cases = [(N_STREAMS, 12, 64, dtype, blocks, (0, 32, 256, 480))
             for blocks in (2, 10)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(N_STREAMS, 12, 64, torch.bfloat16, 1, edges),
              (N_STREAMS, 12, 64, torch.bfloat16, 2, edges),
              (1, 12, 64, torch.bfloat16, 2, edges),
              (1, 12, 64, torch.bfloat16, 10, (0, 65, kv_cap)),
              (16, 8, 32, torch.bfloat16, 2, edges),
              (16, 8, 128, torch.bfloat16, 2, edges),
              (16, 8, 128, torch.bfloat16, 10, (0, 65, kv_cap)),
              (2, 4, 6, torch.float32, 2, (0, 65))]
    worst = 0.0
    for B, H, dh, dtype, blocks, t0s in cases:
        bias = bias_of(blocks)
        R, name = bias.shape[0], str(dtype)[6:]
        path = kernel_path(dtype, dh)
        assert path == ("tensor_core" if dtype == torch.bfloat16
                        and dh in (32, 64, 128) else "cuda_core"), path
        args = inputs(B, R, H * dh, dtype)
        errs = []
        for t0 in t0s:
            _reset_counts()
            got = chunk_cache_attention(*args, bias, t0, H)
            torch.cuda.synchronize()
            sets = _set_paths()["K1"]
            assert sets[path] == 1 and sum(sets.values()) == 1, sets
            want = chunk_cache_attention_ref(*args, bias, t0, H)
            err = (got.float() - want.float()).abs().max().item()
            assert torch.isfinite(got).all(), (B, H, dh, name, R, t0)
            assert err <= K1_TOL[name], (B, H, dh, name, R, t0, err)
            errs.append(err)
        print(f"phase kernel: B={B} heads={H}x{dh} R={R} {name} ({path} "
              f"kernel) t0={list(t0s)} max_abs_err="
              f"{[float(f'{e:.3g}') for e in errs]} tol={K1_TOL[name]:g}")
        if dh == 64 and B == N_STREAMS:
            worst = max(worst, *errs)
        del args, got, want

    # timing: the 15 calls of one 10-s ds2 stream (t0 = 32k, the cache view
    # the decoder passes at that chunk), bfloat16, mean per call: device
    # time under a CUDA graph (no host dispatch between the launches), the
    # wrapper's host time beside it.  At the main path's 128 streams, then at
    # 8 (96 blocks: less than the card's 132 SMs).
    H, D = 12, 768
    bias = bias_of(2)
    R, dh = bias.shape[0], D // H
    intra = bias == 0
    n_intra = int(intra.sum())
    calls = [(32 * k, min(-(-(32 * k + (40 if k == 14 else 32)) // 256) * 256,
                          kv_cap)) for k in range(15)]
    row = None
    for B in (N_STREAMS, 8):
        q, kc, vc, kn, vn = inputs(B, R, D, torch.bfloat16)

        def run(fn):
            def go():
                for t0, cap in calls:
                    fn(q, kc[:cap], vc[:cap], kn, vn, bias, t0, H)
            return go

        _reset_counts()
        ms = graph_ms(run(chunk_cache_attention), len(calls))
        # one warm-up pass and one captured pass of the calls
        assert _set_paths()["K1"] == {"tensor_core": 2 * len(calls),
                                      "cuda_core": 0}, _set_paths()["K1"]
        eager_ms = _cuda_ms(run(chunk_cache_attention), 10) / len(calls)
        host_ms = _host_ms(run(chunk_cache_attention), len(calls))
        plain_ms = _cuda_ms(run(chunk_cache_attention_ref), 10) / len(calls)

        # the library call: scaled_dot_product_attention over [visible cache
        # rows; chunk rows] under the boolean mask of the same layout (q is
        # pre-scaled, so scale 1); inputs built outside the timed region
        def heads(x):                       # [B, T, D] -> [B, H, T, dh]
            return x.reshape(B, -1, H, dh).transpose(1, 2)

        sdpa_in = []
        for t0, _ in calls:
            k_all = torch.cat([kc[:t0].transpose(0, 1), kn], dim=1)
            v_all = torch.cat([vc[:t0].transpose(0, 1), vn], dim=1)
            mask = torch.cat([torch.ones((R, t0), dtype=torch.bool,
                                         device=dev), intra], dim=1)
            sdpa_in.append((heads(q), heads(k_all), heads(v_all), mask))

        def library():
            for qh, kh, vh, mask in sdpa_in:
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               scale=1.0)

        library_ms = graph_ms(library, len(calls))
        del sdpa_in
        # bound, mean over the calls: q, the chunk's k and v, the visible
        # cache rows of k and v and the bias read once, out written once;
        # two products over the visible pairs
        n_bytes = sum(2 * (4 * B * R * D + 2 * t0 * B * D) + 4 * R * R
                      for t0, _ in calls) / len(calls)
        flops = sum(4 * B * D * (R * t0 + n_intra)
                    for t0, _ in calls) / len(calls)
        bound = _bound(n_bytes, flops, "bfloat16")
        print(f"phase kernel: ds2 bf16 B={B} mean per call over t0=0..448: "
              f"kernel {ms:.4f} ms (tensor_core, device time under a CUDA "
              f"graph; {eager_ms:.4f} ms between CUDA events around eager "
              f"calls, as the rows of K2-K4 are timed; the wrapper's host "
              f"time {host_ms:.4f} ms per call), "
              f"plain twin {plain_ms:.4f} ms, library "
              f"(scaled_dot_product_attention, boolean mask, under a CUDA "
              f"graph) {library_ms:.4f} ms, bound {bound[0]:.5f} ms by "
              f"{bound[1]}")
        if row is None:
            row = _row(worst, ms, plain_ms, bound, library_ms)
        else:                 # the row's second call: 8 streams
            row["b8_call"] = {k: v for k, v in _row(
                worst, ms, plain_ms, bound, library_ms).items()
                if k != "max_abs_err"}
        del q, kc, vc, kn, vn

    # the kernel alone (device time under a CUDA graph) where the main path
    # does not go: one stream, a ds10 chunk (R 240) over the same t0s, and
    # the two ends of the main-path call's range of t0
    for B, blocks, t0s in ((1, 2, None), (N_STREAMS, 10, None),
                           (N_STREAMS, 2, (0,)), (N_STREAMS, 2, (448,))):
        bias = bias_of(blocks)
        R = bias.shape[0]
        q, kc, vc, kn, vn = inputs(B, R, D, torch.bfloat16)
        some = calls if t0s is None else [(t0, kv_cap) for t0 in t0s] * 10

        def go():
            for t0, cap in some:
                chunk_cache_attention(q, kc[:cap], vc[:cap], kn, vn, bias,
                                      t0, H)

        ms = graph_ms(go, len(some))
        n_bytes = sum(2 * (4 * B * R * D + 2 * t0 * B * D) + 4 * R * R
                      for t0, _ in some) / len(some)
        print(f"phase kernel: bf16 B={B} R={R} t0="
              f"{'0..448 (mean)' if t0s is None else t0s[0]}: kernel "
              f"{ms:.4f} ms (tensor_core, device time under a CUDA graph), "
              f"byte bound {n_bytes / PEAK_BYTES_PER_S * 1e3:.5f} ms")
        del q, kc, vc, kn, vn
    return row


K7_TOL = 2e-2        # bf16 outputs of O(1): a few of their last places


def _serving_extents(N, T, rows_per_step, main, seed):
    """(lo, plane) of a full serving step at t_main = T: slot i holds a
    stream of 3-16 steps (2-10 s at ds2's 0.64 s) that joined ``age_i``
    steps ago, anywhere in its life; each of its steps showed the step's
    main rows unless the stream stalled then (1 step in 4 for a quarter of
    the slots), its latest step the look-ahead rows too (the flush)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    length = torch.randint(3, 17, (N,), generator=g)
    age = (torch.rand(N, generator=g) * length).long() + 1
    lo = T - age * rows_per_step
    t = torch.arange(T)
    step_of = (T - 1 - t) // rows_per_step          # 0: the latest step
    in_step = (t - (T % rows_per_step)) % rows_per_step
    stalls = torch.rand((N, T // rows_per_step + 1), generator=g) < 0.25
    stalls &= (torch.arange(N) % 4 == 0)[:, None]
    stalls[:, 0] = False
    plane = ((t[None] >= lo[:, None])
             & ((in_step[None] < main) | (step_of[None] == 0))
             & ~stalls[:, step_of])
    return lo, plane


def phase_decode_attention():
    """K7 against its plain version at the emission loop's main-path shapes,
    bf16; the jointer's log-probs through it against the plain version's at
    Base and Large; that the three paths' loops launch it once per layer and
    iteration, captured in the decoders' graphs; each shape timed under a
    CUDA graph beside its bound, the plain version and the library call ->
    the kernel's row."""
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops import decode_attention as k7
    from wav2vec_s_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_ref)
    from wav2vec_s_tpu_torch.stream import caat_step
    from wav2vec_s_tpu_torch.tools.timing import graph_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    # (name, T, N, D, heads, lo, hi, plane); the serving steps' rows: 32 main
    # + 8 look-ahead a step (ds2)
    cases = []
    for D, H in ((768, 12), (1024, 16)):
        lo, plane = _serving_extents(256, 1024, 40, 32, D)
        cases.append((f"serving jointer D={D}", 1024, 256, D, H,
                      lo.to(dev), torch.tensor(1024, device=dev),
                      plane.to(dev)))
    for visible in (40, 256, 512):
        cases.append((f"decoder jointer visible={visible}", 512, 128, 768,
                      12, None, torch.full((128,), visible, device=dev),
                      None))
    for D, H in ((768, 12), (1024, 16)):
        idx = torch.randint(0, 60, (256,), generator=g, device=dev)
        cases.append((f"LM D={D}", 257, 256, D, H, None, idx + 1, None))
    # the decoders' LM: min(max_len, chunks x max_emit) + 1 = 61 rows
    idx = torch.randint(0, 61, (128,), generator=g, device=dev)
    cases.append(("decoder LM", 61, 128, 768, 12, None, idx + 1, None))
    # heads of 6 (the tiny models): loads one element at a time
    small = [("tiny heads of 6, float32", 24, 4, 24, 4, torch.float32),
             ("tiny heads of 6, bfloat16", 24, 4, 24, 4, bf16)]

    row, worst = None, 0.0
    for name, T, N, D, H, lo, hi, plane in cases:
        q, k, v = rand(N, D), rand(T, N, D), rand(T, N, D)
        k7.decode_attention.launches = 0
        got = decode_attention(q, k, v, H, lo=lo, hi=hi, plane=plane)
        torch.cuda.synchronize()
        assert k7.decode_attention.launches == 1
        want = decode_attention_ref(q, k, v, H, lo=lo, hi=hi, plane=plane)
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all(), name
        assert err <= K7_TOL, (name, err)
        worst = max(worst, err)

        def run(fn):
            return lambda: fn(q, k, v, H, lo=lo, hi=hi, plane=plane)

        ms = graph_ms(run(decode_attention), 1)
        plain_ms = graph_ms(run(decode_attention_ref), 1)
        # the host time per call, 24 calls back to back (a Large serving
        # iteration's 12 jointer + 12 LM layers): the wrapper's, and the
        # plain version's, which the emission loop dispatched before K7
        host_ms, plain_host_ms = (
            _host_ms(lambda fn=fn: [run(fn)() for _ in range(24)], 24)
            for fn in (decode_attention, decode_attention_ref))
        t = torch.arange(T, device=dev)[None]
        in_range = (t < hi.reshape(-1, 1)) & (
            t >= (0 if lo is None else lo.reshape(-1, 1)))
        in_range = in_range.expand(N, T)
        seen = in_range if plane is None else in_range & plane
        rows, visible = int(in_range.sum()), int(seen.sum())
        # the library call: scaled_dot_product_attention over per-head
        # views of the time-major cache under the boolean mask of the rows
        # each stream sees; the mask built outside the timed region
        qh = q.view(N, 1, H, D // H).transpose(1, 2)        # [N, H, 1, Dh]
        kh, vh = (x.view(T, N, H, D // H).permute(1, 2, 0, 3)
                  for x in (k, v))                          # [N, H, T, Dh]
        mask = seen[:, None, None, :]
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 1)
        # the visible rows' K and V read once, a plane byte for each row of
        # the range, q read and out written once (bf16); two f32 products
        # over the visible rows, on the CUDA cores
        bound = _bound(4 * visible * D + (0 if plane is None else rows)
                       + 4 * N * D, 4 * visible * D, "float32")
        print(f"phase decode attention: {name} [T={T}, N={N}, D={D}] "
              f"{H} heads, rows in range {rows} of {T * N} "
              f"({100.0 * rows / (T * N):.2f}%), visible {visible} "
              f"({100.0 * visible / (T * N):.2f}%): max_abs_err {err:.3g} "
              f"(tol {K7_TOL:g}); kernel {ms:.4f} ms (device time under a "
              f"CUDA graph; host time a call: the wrapper's {host_ms:.4f} "
              f"ms, the plain version's {plain_host_ms:.4f} ms), bound "
              f"{bound[0]:.5f} ms by {bound[1]} "
              f"({100.0 * bound[0] / ms:.1f}% of it), plain version "
              f"{plain_ms:.4f} ms, library (scaled_dot_product_attention, "
              f"boolean mask, under a CUDA graph) {library_ms:.4f} ms")
        if row is None:
            row = _row(worst, ms, plain_ms, bound, library_ms)
            row["host_ms"], row["plain_host_ms"] = host_ms, plain_host_ms
        del q, k, v, got, want, qh, kh, vh
    row["max_abs_err"] = worst
    for name, T, N, D, H, dtype in small:
        q = torch.randn((N, D), generator=g, device=dev).to(dtype)
        k = torch.randn((T, N, D), generator=g, device=dev).to(dtype)
        v = torch.randn((T, N, D), generator=g, device=dev).to(dtype)
        hi = torch.tensor([0, 1, 7, 24], device=dev)
        plane = torch.rand((N, T), generator=g, device=dev) < 0.7
        got = decode_attention(q, k, v, H, hi=hi, plane=plane)
        want = decode_attention_ref(q, k, v, H, hi=hi, plane=plane)
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else K7_TOL
        assert err <= tol and (got[0] == 0).all(), (name, err)
        print(f"phase decode attention: {name}: max_abs_err {err:.3g} "
              f"(tol {tol:g}), a stream with no row: zeros")

    # the jointer's log-probs through K7 against the plain version's, at
    # Base and Large widths, at the serving step's shape and the decoders'
    w2v, caat, model = _base_model(dev)
    large, _, caat_l = _large_caat(dev)
    for label, m, c, T, N, lo, hi, plane in (
            ("Base serving", model, caat, 1024, 256, cases[0][5],
             cases[0][6], cases[0][7]),
            ("Large serving", large, caat_l, 1024, 256, cases[1][5],
             cases[1][6], cases[1][7]),
            ("Base decoder", model, caat, 512, 128, None,
             torch.full((128,), 300, device=dev), None)):
        D = c.jointer_embed_dim
        h = rand(N, c.decoder_embed_dim)
        jk = [rand(T, N, D) for _ in range(c.jointer_layers)]
        jv = [rand(T, N, D) for _ in range(c.jointer_layers)]
        vis = hi if plane is None else caat_step.SlotPlane(plane, lo, hi)
        k7.decode_attention.launches = 0
        lp = caat_step.jointer_step(m, c, h, jk, jv, vis)
        assert k7.decode_attention.launches == c.jointer_layers
        caat_step.decode_attention = decode_attention_ref
        try:
            lp_ref = caat_step.jointer_step(m, c, h, jk, jv, vis)
            # the same inputs in float32 (the weights are float32, cast per
            # call to the input's dtype): what bfloat16 itself costs here
            lp_f32 = caat_step.jointer_step(
                m, c, h.float(), [x.float() for x in jk],
                [x.float() for x in jv], vis)
        finally:
            caat_step.decode_attention = decode_attention
        # each bf16 version lies up to bf16's own distance from float32, so
        # two as good as each other lie within twice it
        err = (lp - lp_ref).abs().max().item()
        own = (lp_ref - lp_f32).abs().max().item()
        tol = 2 * own
        top2 = lp_ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        same = (lp.argmax(-1) == lp_ref.argmax(-1))[clear]
        assert err <= tol and same.all(), (label, err, tol)
        print(f"phase decode attention: {label} jointer log-probs: max_abs "
              f"{err:.3g} from the plain version, within {tol:.3g} (twice "
              f"the plain bf16 version's distance from float32, {own:.3g}; "
              f"K7's own: {(lp - lp_f32).abs().max().item():.3g}); tokens "
              f"equal on the {int(clear.sum())} of {N} streams whose top "
              f"two differ by more than the tolerance")
        del jk, jv
    del large

    # the three paths' emission loops go through K7: (jointer + LM layers)
    # launches an iteration
    from wav2vec_s_tpu_torch.stream.batched import (
        CachedFusedGreedyDecoder, OneShotCorpusDecoder)
    from wav2vec_s_tpu_torch.stream.serving import ServingSession

    per_iter = caat.jointer_layers + caat.decoder_layers
    vocab = _vocab(caat.vocab_size)
    wavs = _clips([32000] * 4, seed=3)      # 2 s each
    for cls in (CachedFusedGreedyDecoder, OneShotCorpusDecoder):
        dec = cls(model, vocab, w2v, max_len=256, max_emit_per_chunk=4,
                  t_cap=512, blocks_per_step=2)
        dec.decode_corpus(wavs)               # captures the graphs
        loop = dec._loop
        cap, graph = next(iter(loop.graphs.items()))
        kernels = _device_kernels(graph.replay)
        n = sum(c for k, c in kernels.items() if "decode_attention" in k)
        assert n == dec.max_emit * per_iter, (cls.__name__, n, kernels)
        k7.decode_attention.launches = 0
        dec._greedy(loop, cap)                # the same loop, eager
        assert k7.decode_attention.launches == dec.max_emit * per_iter
        print(f"phase decode attention: {cls.__name__}: a replayed chunk "
              f"runs {n} K7 kernels = {dec.max_emit} iterations x "
              f"({caat.jointer_layers} jointer + {caat.decoder_layers} LM "
              f"layers)")
    sess = ServingSession(model, vocab, w2v, n_slots=4, t_cap=1024,
                          blocks_per_step=2)
    for i, wav in enumerate(wavs):
        assert sess.add_stream(f"s{i}")
        sess.push(f"s{i}", wav, is_end=True)
    steps = []
    while sess._by_id:
        k7.decode_attention.launches = 0
        sess.step()
        steps.append(k7.decode_attention.launches)
    # the first step resets the slots: one more LM step
    assert steps[0] == sess.max_emit * per_iter + caat.decoder_layers
    assert set(steps[1:]) == {sess.max_emit * per_iter}, steps
    print(f"phase decode attention: ServingSession: {steps[1]} K7 "
          f"launches a step = {sess.max_emit} iterations x {per_iter} "
          f"layers (+{caat.decoder_layers} in the step that resets)")
    return row


def _sdpa_inputs(q, k, v, pad, H, T, mc, rc):
    """The library call's view of a packed flash-attention call: per-head
    [B, H, S, dh] views and the [B, 1, S, S] boolean mask of the same
    layout and key padding."""
    import torch
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout

    B, S, D = q.shape
    allowed = torch.as_tensor(block_layout(T, mc, rc).allowed,
                              device=q.device)
    mask = allowed[None, None] & ~pad[:, None, None, :]
    return [t.reshape(B, S, H, D // H).transpose(1, 2)
            for t in (q, k, v)] + [mask]


def _allowed_pairs(T, mc, rc):
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout

    return int(block_layout(T, mc, rc).allowed.sum())


def phase_flash():
    """K2 vs twin at the one-shot encoder's full-width call and at the
    Large seq2seq encoder's training call (phase 17c) -> the kernel's
    row."""
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        TILES, blockwise_flash_attention_packed,
        blockwise_flash_attention_ref, kernel_path, tile_kinds)

    B, T, mc, H, D = ENCODE_BATCH, 488, 16, 12, 768
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = 0.0
    # (B, T, H, D, dtypes): the one-shot encode; the Large call's encoder
    # (B 2 per microbatch, 16 heads of 64 over 1024)
    cases = ((B, T, H, D, (torch.float32, torch.bfloat16)),
             (LARGE_MICRO_B, TRAIN_T, 16, 1024, (torch.bfloat16,)))
    for (B, T, H, D, dtypes), rc in ((c, rc) for c in cases
                                     for rc in (8, 0)):
        S = block_layout(T, mc, rc).total_len
        shares = {}
        for path, (qt, kt) in TILES.items():
            kinds = tile_kinds(T, mc, rc, qt, kt)
            shares[path] = (f"{int((kinds != 0).sum())} of {kinds.size} "
                            f"tiles of {qt} x {kt}, "
                            f"{(kinds != 0).sum() * qt * kt / S / S:.3f} of "
                            f"S x S")
        print(f"phase flash: B={B} H={H} D={D} S={S} rc={rc}: computed "
              f"{shares}")
        # non-contiguous key padding of one stream: a frame tail and the
        # last rc copies (tests/test_pallas_attention.py)
        pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
        pad[1, T - 10:T] = True
        pad[1, S - 3:] = True
        valid = ~pad
        for dtype in dtypes:
            q, k, v = (torch.randn((B, S, D), generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            args = (q, k, v, pad, H, T, mc, rc)
            _reset_counts()
            out, m, l = blockwise_flash_attention_packed(*args,
                                                         return_stats=True)
            torch.cuda.synchronize()
            path = kernel_path(dtype, D // H)
            assert _set_paths()["K2"][path] == 1
            assert path == ("tensor_core" if dtype == torch.bfloat16
                            else "cuda_core")
            want, m_want, l_want = blockwise_flash_attention_ref(*args)
            err = (out[valid].float() - want[valid].float()).abs().max()
            err = err.item()
            rows = valid[:, None, :].expand_as(m)
            stat_err = max(((a[rows] - b[rows]).abs()
                            / (1.0 + b[rows].abs())).max().item()
                           for a, b in ((m, m_want), (l, l_want)))
            print(f"phase flash: B={B} H={H} D={D} S={S} rc={rc} "
                  f"{str(dtype)[6:]} ({path} kernel) max_abs_err={err:.3g} "
                  f"tol={tol[dtype]:g}; m/l max err/(1+|x|)={stat_err:.3g} "
                  f"tol=1e-4")
            assert err <= tol[dtype], (rc, dtype, err)
            assert stat_err <= 1e-4, (rc, dtype, stat_err)
            worst = max(worst, err)
            del out, m, l, want, m_want, l_want

    # timing: the main path's call (rc 8, bfloat16), mean per call
    B, T, H, D = cases[0][:4]
    S = block_layout(T, 16, 8).total_len
    q, k, v = (torch.randn((B, S, D), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
    args = (q, k, v, pad, H, T, mc, 8)
    _reset_counts()
    ms = _cuda_ms(lambda: blockwise_flash_attention_packed(*args), 20)
    _on_tensor_cores(_set_paths(), {"K2": 21})
    plain_ms = _cuda_ms(lambda: blockwise_flash_attention_ref(*args), 5)
    qh, kh, vh, mask = _sdpa_inputs(q, k, v, pad, H, T, mc, 8)
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), 20)
    # bound: q, k, v and the padding mask read once, out written once; two
    # products over the allowed pairs
    bound = _bound(2 * 4 * B * S * D + B * S,
                   4 * B * D * _allowed_pairs(T, mc, 8), "bfloat16")
    print(f"phase flash: B={B} S={S} H={H} dh={D // H} bf16 per call: "
          f"tensor-core kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, library "
          f"(scaled_dot_product_attention, boolean mask) {library_ms:.4f} "
          f"ms, bound {bound[0]:.5f} ms by {bound[1]}")
    return _row(worst, ms, plain_ms, bound, library_ms)


TRAIN_T = 500        # 499 frames of 10 s, padded to the seq multiple of 2


def _flash_shard(q, k, v, do, lay, rate, seed, offset, out, grads):
    """K2 and K3 on the rows 3: of the batch with ``dropout_row0`` 3 (a
    data-parallel shard): equal to the whole batch's rows, bit for bit, and
    to the twins under the same row base."""
    import torch
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        _keep_scale, blockwise_flash_attention_bwd,
        blockwise_flash_attention_bwd_ref, blockwise_flash_attention_packed,
        blockwise_flash_attention_ref)

    r0 = 3
    part = [t[r0:].contiguous() for t in (q, k, v, do)]
    lay_p = (lay[0][r0:].contiguous(),) + lay[1:]
    o, m, l = blockwise_flash_attention_packed(
        *part[:3], *lay_p, rate, True, seed, offset, dropout_row0=r0)
    dq, dk, dv = blockwise_flash_attention_bwd(
        *part[:3], o, part[3], m, l, *lay_p, rate, seed, offset, r0)
    torch.cuda.synchronize()
    assert torch.equal(o, out[r0:])
    for a, b in zip((dq, dk, dv), grads):
        assert torch.equal(a, b[r0:])
    want = blockwise_flash_attention_ref(*part[:3], *lay_p, rate, seed,
                                         offset, r0)[0]
    ref = blockwise_flash_attention_bwd_ref(*part[:3], o, part[3], m, l,
                                            *lay_p, rate, seed, offset, r0)
    # the twins' masks: the shard's are the whole batch's rows
    B, S, H = q.shape[0], q.shape[1], lay[1]
    assert torch.equal(_keep_scale(B - r0, H, S, rate, seed, offset,
                                   q.device, r0),
                       _keep_scale(B, H, S, rate, seed, offset,
                                   q.device)[r0:])
    valid = ~lay_p[0]
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    assert (o[valid].float() - want[valid].float()).abs().max() <= tol
    for i, (a, b) in enumerate(zip((dq, dk, dv), ref)):
        if i == 0:
            a, b = a[valid], b[valid]
        assert ((a.float() - b.float()).abs().max()
                / b.float().abs().max()) <= (1e-5 if q.dtype == torch.float32
                                             else 1e-2)
    print(f"phase flash backward: rows {r0}: of {q.shape[0]} with "
          f"dropout_row0 {r0}: K2 output and K3 grads == the whole batch's "
          f"rows bit for bit; twins under the row base == the whole twin's "
          f"rows")


def phase_flash_bwd():
    """K3 (and K2 with dropout) vs their twins at the CAAT training call and
    at the Large seq2seq call (phase 17c) -> the kernel's row."""
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_bwd, blockwise_flash_attention_bwd_ref,
        blockwise_flash_attention_packed, blockwise_flash_attention_ref)

    B, T, mc, H, D = TRAIN_B, TRAIN_T, 16, 12, 768
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    seed, offset = 0x1234_5678_9ABC_DEF, 17
    # forward: max abs error on valid rows; backward: max abs error over
    # the largest gradient entry (dQ on valid rows; dK and dV everywhere)
    tol_fwd = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    tol_bwd = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    worst = 0.0
    # (B, H, D, dtypes): the CAAT step (the Base CTC step of phase 17b
    # too); the Base seq2seq and the Large microbatches (update_freq 2)
    cases = ((B, H, D, (torch.float32, torch.bfloat16)),
             (B // 2, H, D, (torch.bfloat16,)),
             (LARGE_MICRO_B, 16, 1024, (torch.bfloat16,)))
    for (B, H, D, dtypes), rc in ((c, rc) for c in cases for rc in (8, 0)):
        S = block_layout(T, mc, rc).total_len
        pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
        pad[1, T - 10:T] = True
        pad[1, S - 3:] = True
        valid = ~pad
        for dtype in dtypes:
            q, k, v, do = (torch.randn((B, S, D), generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            do = do * valid[:, :, None].to(dtype)   # padded rows: stripped
            for rate in (0.0, 0.1):
                lay = (pad, H, T, mc, rc)
                _reset_counts()
                out, m, l = blockwise_flash_attention_packed(
                    q, k, v, *lay, rate, True, seed, offset)
                torch.cuda.synchronize()
                want = blockwise_flash_attention_ref(q, k, v, *lay, rate,
                                                     seed, offset)[0]
                err_f = (out[valid].float() - want[valid].float()).abs().max()
                err_f = err_f.item()
                del want
                got = blockwise_flash_attention_bwd(
                    q, k, v, out, do, m, l, *lay, rate, seed, offset)
                again = blockwise_flash_attention_bwd(
                    q, k, v, out, do, m, l, *lay, rate, seed, offset)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                del again
                path, other = (("tensor_core", "cuda_core")
                               if dtype == torch.bfloat16
                               else ("cuda_core", "tensor_core"))
                sets = _set_paths()
                assert (sets["K2"], sets["K3"]) == (
                    {path: 1, other: 0}, {path: 2, other: 0}), sets
                ref = blockwise_flash_attention_bwd_ref(
                    q, k, v, out, do, m, l, *lay, rate, seed, offset)
                errs = []
                for i, (a, b) in enumerate(zip(got, ref)):
                    if i == 0:
                        a, b = a[valid], b[valid]
                    assert torch.isfinite(a).all()
                    worst = max(worst, (a.float() - b.float()).abs().max()
                                .item())
                    errs.append(((a.float() - b.float()).abs().max()
                                 / b.float().abs().max()).item())
                if rate and B > 3:
                    _flash_shard(q, k, v, do, lay, rate, seed, offset, out,
                                 got)
                print(f"phase flash backward: B={B} H={H} D={D} S={S} rc={rc} "
                      f"{str(dtype)[6:]} ({path} kernels) rate={rate}: "
                      f"forward max_abs_err="
                      f"{err_f:.3g} (tol {tol_fwd[dtype]:g}); dQ, dK, dV max "
                      f"|diff| / max |grad| = "
                      f"{', '.join(f'{e:.3g}' for e in errs)} (tol "
                      f"{tol_bwd[dtype]:g}); two runs bit-identical: {same}")
                assert err_f <= tol_fwd[dtype], (rc, dtype, rate, err_f)
                assert max(errs) <= tol_bwd[dtype], (rc, dtype, rate, errs)
                assert same, (rc, dtype, rate)
                del got, ref, out, m, l

    # timing: the training call (rc 8, bfloat16, dropout 0.1), mean per call
    B, H, D = cases[0][:3]
    S = block_layout(T, mc, 8).total_len
    q, k, v, do = (torch.randn((B, S, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
    lay, rate = (pad, H, T, mc, 8), 0.1
    times = {}
    _reset_counts()
    for r in (0.0, rate):
        out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, r, True,
                                                     seed, offset)
        times[r] = (
            _cuda_ms(lambda: blockwise_flash_attention_packed(
                q, k, v, *lay, r, True, seed, offset), 20),
            _cuda_ms(lambda: blockwise_flash_attention_bwd(
                q, k, v, out, do, m, l, *lay, r, seed, offset), 20))
    _on_tensor_cores(_set_paths(), {"K2": 2 * 22, "K3": 2 * 21})
    plain_ms = _cuda_ms(lambda: blockwise_flash_attention_bwd_ref(
        q, k, v, out, do, m, l, *lay, rate, seed, offset), 3)
    # the library call: scaled_dot_product_attention forward + backward
    # (its own dropout of the same rate) and its forward alone; K3 is a
    # backward only, so its yardstick is the difference of the two
    qh, kh, vh, mask = _sdpa_inputs(q, k, v, pad, H, T, mc, 8)
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    doh = do.reshape(B, S, H, D // H).transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           dropout_p=rate)
        torch.autograd.grad(o, leaves, doh)

    library_both_ms = _cuda_ms(library, 20)
    library_fwd_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, dropout_p=rate), 20)
    library_ms = library_both_ms - library_fwd_ms
    # bound: q, k, v, out, dout, m, l and the padding mask read once, dQ,
    # dK, dV written once; five products over the allowed pairs
    bound = _bound(2 * 8 * B * S * D + 2 * 4 * B * H * S + B * S,
                   10 * B * D * _allowed_pairs(T, mc, 8), "bfloat16")
    print(f"phase flash backward: B={B} S={S} H={H} dh={D // H} bf16 per "
          f"call, tensor-core kernels: K3 {times[rate][1]:.4f} ms at "
          f"dropout {rate} ({times[0.0][1]:.4f} ms without), plain twin "
          f"{plain_ms:.4f} ms, library (scaled_dot_product_attention, "
          f"boolean mask, dropout {rate}) backward alone {library_ms:.4f} ms "
          f"= forward + backward {library_both_ms:.4f} ms - forward "
          f"{library_fwd_ms:.4f} ms, bound {bound[0]:.5f} ms by "
          f"{bound[1]}; K2 at this call with row stats: "
          f"{times[rate][0]:.4f} ms at dropout {rate}, {times[0.0][0]:.4f} "
          f"ms without")
    return _row(worst, times[rate][1], plain_ms, bound, library_ms)


def _keep_share(keep, p):
    """Keep share within 4 sigma of 1 - p."""
    n = keep.numel()
    share = keep.float().mean().item()
    return share, abs(share - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


DROPOUT_SEED = 0x1234_5678_9ABC_DEF


def _hold_dropout(x, p, seed, offset, index=None):
    """K4 on ``x`` at rate ``p`` (``index``: a shard's index map): output
    and mask bit-equal to the twin's, keep share within 4 sigma of 1 - p,
    the backward's mask the forward's, a new seed and a new offset a new
    mask -> (max abs error, keep share)."""
    import torch
    from wav2vec_s_tpu_torch.ops.dropout import (
        dropout_ref, hw_dropout, keep_mask)

    key = (tuple(x.shape), x.dtype, p, index)
    got = hw_dropout(x, p, seed, offset, index)
    torch.cuda.synchronize()
    want = dropout_ref(x, p, seed, offset, index)
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), key
    del got, want
    ones = torch.ones_like(x)
    mask = hw_dropout(ones, p, seed, offset, index) != 0
    assert torch.equal(mask, keep_mask(x.numel(), p, seed, offset, x.device,
                                       index).reshape(x.shape)), key
    share, ok = _keep_share(mask, p)
    assert ok, (key, share)
    xg = x.detach().clone().requires_grad_(True)
    hw_dropout(xg, p, seed, offset, index).backward(ones)
    assert torch.equal(xg.grad != 0, mask), ("fwd/bwd masks", key)
    for s, o in ((seed + 1, offset), (seed, offset + 1)):
        other = hw_dropout(ones, p, s, o, index) != 0
        diff = (other != mask).float().mean().item()
        assert diff > p * (1 - p), (key, s, o, diff)
    return err, share


def phase_dropout():
    """K4 vs its twin: bit-equal outputs and masks at the dropout shapes of
    the CAAT step and of the pre-training step (phase 17 holds it at the
    offline-ASR calls' own) -> the kernel's row."""
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops.dropout import dropout_ref, hw_dropout

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    N = 8 * 748                       # encoder rows of the full-width step
    # pre-training (phase 15): dropout_input on the 768-wide projected
    # features, dropout_features on the 512-wide conv features (627 frames
    # of a 200960-sample crop), the encoder's FFN rows at T 628 and, under
    # dense attention, the probabilities at the widest packed length S 940
    P, PF = PRETRAIN_B * PRETRAIN_T, PRETRAIN_B * (PRETRAIN_T - 1)
    shapes = [(N, 768), (N, 3072), (8 * 12 * 748, 748),
              (PF, 768), (PF, 512), (P, 3072), (PRETRAIN_B * 12 * 940, 940)]
    seed, offset = DROPOUT_SEED, 17
    worst = 0.0
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            for p in (0.1, 0.3):
                err, share = _hold_dropout(x, p, seed, offset)
                worst = max(worst, err)
                print(f"phase dropout: {shape} {str(dtype)[6:]} p={p}: "
                      f"outputs and masks bit-equal to the twin, keep "
                      f"share {share:.5f}, fwd == bwd mask, new seed and "
                      f"new offset change the mask")
            del x
    _dropout_shards(dev, seed, offset)
    # timing: the attention-probability call, bf16, p 0.1
    x = torch.randn(shapes[2], generator=g, device=dev).to(torch.bfloat16)
    ms = _cuda_ms(lambda: hw_dropout(x, 0.1, seed, offset), 20)
    plain_ms = _cuda_ms(lambda: dropout_ref(x, 0.1, seed, offset), 3)
    library_ms = _cuda_ms(lambda: F.dropout(x, 0.1), 20)
    gbs = 2 * x.numel() * x.element_size() / ms / 1e6
    # bound: the tensor read once and written once; one multiply per element
    bound = _bound(2 * x.numel() * x.element_size(), x.numel(), "float32")
    print(f"phase dropout: {tuple(x.shape)} bf16 per call: kernel "
          f"{ms:.4f} ms ({gbs:.0f} GB/s), plain twin {plain_ms:.4f} ms, "
          f"library (F.dropout) {library_ms:.4f} ms, bound {bound[0]:.5f} "
          f"ms by {bound[1]}")
    return _row(worst, ms, plain_ms, bound, library_ms)


def _dropout_shards(dev, seed, offset):
    """K4 on shards: a data-parallel rank's rows, a context-parallel rank's
    time block (unequal spans) and both, of [8, 748, 768] (the CAAT step's
    encoder rows) and [8, 12, 748, 748] (its attention probabilities, time
    on axis 2), and of [8, 37, 77] (no aligned group of 4: every element
    draws its own Philox block): bit-equal to the twin under the same index
    map, and to the matching part of the whole tensor's mask."""
    import torch
    from wav2vec_s_tpu_torch.ops.dropout import (
        DropoutContext, dropout_ref, hw_dropout)
    from wav2vec_s_tpu_torch.parallel.mesh import Shard

    g = torch.Generator(device=dev).manual_seed(5)
    ctx = DropoutContext(torch.Generator())
    for shape, axis in (((8, 748, 768), 1), ((8, 12, 748, 748), 2),
                        ((8, 37, 77), 1)):
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        whole = hw_dropout(x, 0.1, seed, offset)
        T = shape[axis]
        t0, t1 = T // 3 + 1, T - T // 4        # not multiples of 4
        for rows in ((4, 8), (0, 8), (3, 5)):
            for seq in (None, (t0, t1)):
                ctx.shard = (None if rows == (0, 8)
                             else Shard(rows[0], rows[1], 8))
                part = x[rows[0]:rows[1]]
                split = None
                if seq is not None:
                    part = part.narrow(axis, seq[0], seq[1] - seq[0])
                    split = (axis, seq[0], T)
                part = part.contiguous()
                index = ctx.index(tuple(part.shape), split)
                got = hw_dropout(part, 0.1, seed, offset, index)
                torch.cuda.synchronize()
                want = whole[rows[0]:rows[1]]
                if seq is not None:
                    want = want.narrow(axis, seq[0], seq[1] - seq[0])
                assert torch.equal(got, dropout_ref(part, 0.1, seed, offset,
                                                   index)), (shape, rows, seq)
                assert torch.equal(got, want), (shape, rows, seq)
        del x, whole
        print(f"phase dropout: {shape} bf16 p=0.1 shards (rows 4:8, 3:5; "
              f"axis {axis} {T // 3 + 1}:{T - T // 4}; both): kernel == "
              f"twin under the index map == the whole tensor's mask")


def _lattice_inputs(dev, B, T, U, V, seed):
    import torch
    from wav2vec_s_tpu_torch.ops.transducer.lattice import (
        delay_cost_diag_positive, lattice_log_probs_lse)

    g = torch.Generator(device=dev).manual_seed(seed)
    acts = torch.randn((B, T, U, V), generator=g, device=dev)
    labels = torch.randint(1, V, (B, U - 1), generator=g, device=dev)
    # ragged: the first utterance fills the lattice, the others do not
    al = torch.randint(max(1, T // 2), T + 1, (B,), generator=g, device=dev)
    ll = torch.randint(U // 2, U, (B,), generator=g, device=dev)
    al[0], ll[0] = T, U - 1
    dv = delay_cost_diag_positive((B, T, U), al, ll)
    lpb, lpe, _ = lattice_log_probs_lse(acts, labels, 0)
    return acts, labels, al, ll, dv, lpb.contiguous(), lpe


def _rel_err(a, b, where=None):
    e = (a.double() - b.double()).abs() / (1.0 + b.double().abs())
    return (e if where is None else e[where]).max().item()


# the full-width step's lattice, the bench.py lattice, a deep one, then the
# lattice of a loss chunk of the long-target training step (phase 11: 299
# labels, G 8, two rows per chunk) and a deep one past the warp set's U
LATTICE_SHAPES = ((8, 8, 41, 10000), (16, 32, 65, 512), (4, 512, 129, 512),
                  (2, 8, 300, 512), (2, 64, 300, 512))
LAT_TIMED = (0, 1, 3)      # the shapes timed
LAT_LOSS = (0, 1, 2, 3, 4)  # the shapes whose loss is held to float64 twins
LAT_LAUNCHES = 50          # launches of a lattice kernel in one CUDA graph
PROBE_STEPS = 20000        # dependent steps of one probe launch
CHAIN_LOADS = 4096         # dependent loads of one load-chain launch


def _lattice_f64(lpb, lpe, al, ll, dv, valid, kernel_out, label):
    """err/(1+|x|) against float64 twins (on the CPU) of each lattice
    kernel alone, of the block set's unfused sequence and of the fused
    walks, each beside the f32 twins' own; printed on one line.
    ``kernel_out``: {alphas, betas (single kernels), ad, bd (the unfused
    sequence: coefficients from the stored alpha / beta, then K6), walk a,
    walk ad, walk b, walk bd}.  K6 alone runs on the float64 coefficients
    rounded to f32, its reference the float64 rows on those same
    coefficients.  Returns {name: err} and {name: float64 reference}."""
    import torch
    from wav2vec_s_tpu_torch.ops.transducer import kernels, lattice

    def cpu(t, dtype=torch.float64):
        return t.detach().cpu().to(dtype)

    al, ll, valid = al.cpu(), ll.cpu(), valid.cpu()
    shape = tuple(lpb.shape)
    t_valid, emit_ok = lattice.lattice_masks(shape, al, ll)
    coef = {}

    def grab(a, pb, c, reverse=False):
        coef[reverse] = (a, pb, c)
        return lattice.affine_rows(a, pb, c, reverse)

    ref, twin = {}, {}
    for dtype, into in ((torch.float64, ref), (torch.float32, twin)):
        b_, e_, d_ = (cpu(t, dtype) for t in (lpb, lpe, dv))
        into["alphas"] = lattice.alphas(b_, e_)
        into["betas"] = lattice.betas(b_, e_, al, ll)[0]
        into["ad"] = lattice.expected_delay(
            b_, e_, into["alphas"], d_,
            rows=grab if dtype == torch.float64 else lattice.affine_rows)
        down, up = lattice.beta_shifts(into["betas"], ll)
        into["bd"] = lattice.expected_delay_bwd(
            b_, e_, into["betas"], down, up, d_, t_valid, emit_ok,
            rows=grab if dtype == torch.float64 else lattice.affine_rows)[0]
    where = {"betas": valid, "bd": valid, "walk b": valid, "walk bd": valid}
    errs = {}
    of = {"walk a": "alphas", "walk b": "betas", "walk ad": "ad",
          "walk bd": "bd"}
    for name, got in kernel_out.items():
        errs[name] = _rel_err(cpu(got), ref[of.get(name, name)],
                              where.get(name))
        if not name.startswith("walk"):
            errs[f"f32 twin {name}"] = _rel_err(twin[name], ref[name],
                                                where.get(name))
    for rev, (a, pb, c) in coef.items():
        r32 = [x.float() for x in (a, pb, c)]
        want = lattice.affine_rows(*(x.double() for x in r32), reverse=rev)
        got = kernels.affine_rows(*(x.to(lpb.device) for x in r32),
                                  reverse=rev)
        name = "affine_rows " + ("reverse" if rev else "forward")
        w = valid if rev else None
        errs[name] = _rel_err(cpu(got), want, w)
        errs[f"f32 twin {name}"] = _rel_err(
            lattice.affine_rows(*r32, reverse=rev), want, w)
    print(f"phase {label}: {list(shape)} {kernels.lattice_path(shape[2])} "
          f"set, err/(1+|x|) vs float64 twins: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + " (ad, bd: the unfused sequence; walk ad, walk bd: the fused "
            "walks)")
    return errs, ref


def _step_probe():
    """The probe's C functions (step, load chain): tools/lattice_step_probe.cu
    compiled into a shared library of its own (not part of the kernel
    library) and loaded with ctypes."""
    import ctypes
    import tempfile

    from wav2vec_s_tpu_torch.ops import native

    src = native.CSRC.parent / "tools" / "lattice_step_probe.cu"
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lattice_step_probe.so")
        nvcc = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-shared",
                               "-o", so, str(src)], capture_output=True,
                              text=True)
        if nvcc.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{nvcc.stdout}"
                               f"{nvcc.stderr}")
        lib = ctypes.CDLL(so)                          # stays mapped
    step, chain = lib.w2vs_lattice_step_probe, lib.w2vs_load_chain_probe
    step.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    chain.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    for fn in (step, chain):
        fn.restype = ctypes.c_int
    return step, chain


# probe kinds: a log-add-exp step, an affine step, the fused walks' step
LAE, AFFINE, FUSED = 0, 1, 2


def _step_ms(fn, out, B, U, kind, shuffle):
    """One step of the recursion in ms, from one probe launch under a CUDA
    graph: the warp set's step (heads in registers, one warp shuffle, no
    barrier) or, without ``shuffle``, the block set's (shared memory + block
    barrier); ``out``: any float32 tensor of at least B * U elements."""
    import torch
    from wav2vec_s_tpu_torch.tools.timing import graph_ms

    def go():
        err = fn(out.data_ptr(), B, U, PROBE_STEPS, kind, -0.37,
                 int(shuffle), torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    return graph_ms(go, 1, reps=5) / PROBE_STEPS


def _round_trips(chain):
    """{where: ns} of one dependent global load: a random cycle through 4
    MB (held in the L2 cache: one chain replayed from a CUDA graph, warm)
    and through 512 MB (device memory: each launch starts at another place
    of the cycle, so no load finds its line in the cache)."""
    import torch
    from wav2vec_s_tpu_torch.tools.timing import graph_ms

    out, res = {}, torch.empty(1, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for where, n in (("L2", 1 << 20), ("device memory", 1 << 27)):
        order = torch.randperm(n, generator=g, device="cuda")
        nxt = torch.empty(n, dtype=torch.int32, device="cuda")
        nxt[order] = order.roll(-1).to(torch.int32)      # one cycle
        starts = order[::n // 8].tolist()
        del order

        def go(start=0):
            err = chain(nxt.data_ptr(), start, CHAIN_LOADS, res.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        if where == "L2":
            out[where] = graph_ms(go, 1, reps=5) / CHAIN_LOADS * 1e6
        else:
            go()
            ms = []
            for start in starts[1:]:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                go(start)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            out[where] = min(ms) / CHAIN_LOADS * 1e6
        del nxt
    return out


def _device_kernels(fn):
    """{name: count} of the device kernels that one call of ``fn``
    launches, read from torch.profiler traces of two warm calls: the fuller
    one (a trace may drop events, it never adds any)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen.append(collections.Counter(
            e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)))
    return max(seen, key=lambda c: sum(c.values()))


def _kernel_diff(new, old, top=6):
    """The kernels whose counts differ most between two traces, as
    'name +n', by short name (the template and the namespaces dropped)."""
    import collections

    def short(counts):
        out = collections.Counter()
        for k, n in counts.items():
            k = k.replace("(anonymous namespace)::", "")
            out[k.split("<")[0].split("(")[0].split("::")[-1]
                .removeprefix("void ").strip()] += n
        return out

    new, old = short(new), short(old)
    diff = sorted(((new[k] - old[k], k) for k in set(new) | set(old)
                   if new[k] != old[k]), key=lambda x: (abs(x[0]), x[1]),
                  reverse=True)
    return ", ".join(f"{k} {n:+d}" for n, k in diff[:top])


# loss total err/(1+|x|), delay err/(1+|x|), grad max|diff|/max|g| of the
# kernels against float64 twins, and the most the f32 twins' own error may
# widen them to (the f32 twins showed 1.3e-6, 9.0e-4, 2.9e-3 at T 512)
LOSS_TOL, LOSS_TOL_CEILING = (1e-5, 5e-4, 1e-3), (1e-5, 2e-3, 5e-3)
# err/(1+|x|) of each kernel against its twin, f32 throughout; the twins'
# prefix form loses ~1e-6 relative to the recursion at T 512 (the kernels
# are the more exact of the two); betas and bd on the valid cells
LAT_TOL = {"alphas": 2e-5, "betas": 5e-5, "affine_rows": 2e-5,
           "forward_walk alphas": 2e-5, "forward_walk ad": 2e-5,
           "reverse_walk betas": 5e-5, "reverse_walk bd": 2e-5}
# err/(1+|x|) of the block set's fused walks' ad and bd against float64
# twins: they read 4.6e-7 to 8.7e-7 at U 300 (T 8 and 64), where the
# unfused sequence they replace read 5.0e-4 to 1.1e-3
BLOCK_WALK_F64_TOL = 1e-5


def _check_loss(loss_grad, acts, shape, label="lattice"):
    """The loss and d/dacts through the kernels (CUDA, f32) against the
    twins on the CPU in float64; the f32 twins' own error is printed beside
    it (their prefix form cancels large partial sums, see PERF.md)."""
    ref = loss_grad(acts.cpu().double())
    errs_vs_f64 = {}
    for name, res in (("kernels", loss_grad(acts)),
                      ("f32 twins", loss_grad(acts.cpu()))):
        t, d, g_ = (r.cpu().double() for r in res)
        errs_vs_f64[name] = (
            _rel_err(t, ref[0]), _rel_err(d, ref[1]),
            ((g_ - ref[2]).abs().max() / ref[2].abs().max()).item())
    print(f"phase {label}: {list(shape)} loss vs float64 twins (total "
          f"err/(1+|x|), delay err/(1+|x|), grad max|diff|/max|g|): "
          + "; ".join(f"{k} " + ", ".join(f"{e:.3g}" for e in v)
                      for k, v in errs_vs_f64.items())
          + " (kernel tol: 1e-5, 5e-4, 1e-3, or the f32 twins' own error "
            "where larger, capped at 1e-5, 2e-3, 5e-3)")
    # f32 bounds the posteriors exp(alpha + beta - ll) to ~|alpha| * eps
    # relative (|alpha| ~ 2400 at T 512): the kernels must be as exact as
    # the plain f32 computation, within the fixed bounds where that is
    # tighter, and never past the ceilings (which the twins must meet too)
    twin = errs_vs_f64["f32 twins"]
    kern = errs_vs_f64["kernels"]
    if shape[2] > 256:
        # the block set's fused walks: delay and gradient within twice the
        # f32 twins' own error
        assert kern[1] <= 2 * twin[1] and kern[2] <= 2 * twin[2], (
            errs_vs_f64)
        if shape[1] == 8:
            # 299 labels in 8 frames: the f32 twins themselves miss the
            # fixed bounds (a few paths of |alpha| ~ 2000)
            return
    bound = [min(c, max(b, t)) for b, t, c in zip(LOSS_TOL, twin,
                                                  LOSS_TOL_CEILING)]
    assert all(t <= c for t, c in zip(twin, LOSS_TOL_CEILING)), twin
    assert all(e <= b for e, b in zip(errs_vs_f64["kernels"], bound)), (
        errs_vs_f64, bound)


def _hold_lattice(dev, B, T, U, V, seed, label):
    """Phase 5's comparison at one lattice [B, T, U] (seeded inputs over V
    symbols, ragged lengths): K5a, K5b, K6 and both fused walks on the set
    that ``kernels.lattice_path`` picks against their twins at
    ``LAT_TOL``, and every one against float64 twins (the block set's
    walks held there at ``BLOCK_WALK_F64_TOL``) -> a namespace of the
    inputs, the set, ``errs`` (vs the twins), ``f64`` (vs float64) and
    ``abs_errs`` (max |diff| vs the twins, per kernel)."""
    import types

    import torch
    from wav2vec_s_tpu_torch.ops.transducer import kernels, lattice

    acts, labels, al, ll, dv, lpb, lpe = _lattice_inputs(dev, B, T, U, V,
                                                         seed)
    valid = ((torch.arange(T, device=dev)[None, :, None]
              < al[:, None, None])
             & (torch.arange(U, device=dev)[None, None, :]
                <= ll[:, None, None]))
    path = kernels.lattice_path(U)
    _reset_counts()
    a_k = kernels.alphas(lpb, lpe)
    a_t = lattice.alphas(lpb, lpe)
    b_k = kernels.betas(lpb, lpe, al, ll)
    b_t = lattice.betas(lpb, lpe, al, ll)[0]
    t_valid, emit_ok = lattice.lattice_masks((B, T, U), al, ll)
    down, up = lattice.beta_shifts(b_k, ll)
    ad_k = lattice.expected_delay(lpb, lpe, a_k, dv,
                                  rows=kernels.affine_rows)
    ad_t = lattice.expected_delay(lpb, lpe, a_k, dv)
    bd_k = lattice.expected_delay_bwd(lpb, lpe, b_k, down, up, dv,
                                      t_valid, emit_ok,
                                      rows=kernels.affine_rows)[0]
    bd_t = lattice.expected_delay_bwd(lpb, lpe, b_k, down, up, dv,
                                      t_valid, emit_ok)[0]
    fa, fad = kernels.alphas_and_expected_delay(lpb, lpe, dv)
    fb, fbd = kernels.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    f_down, f_up = lattice.beta_shifts(fb, ll)
    fad_t = lattice.expected_delay(lpb, lpe, fa, dv)
    fbd_t = lattice.expected_delay_bwd(lpb, lpe, fb, f_down, f_up, dv,
                                       t_valid, emit_ok)[0]
    torch.cuda.synchronize()
    # every launch on the chosen set: the single recursions called
    # above and each fused walk once
    counts, sets = _counts(), _set_paths()
    singles = {"K5a": 1, "K5b": 1, "K6": 2}
    on = "" if path == kernels.WARP else "_block"
    for name in WALKS:
        assert counts[name + on] == 1, counts
    for k, n in singles.items():
        want = {kernels.WARP: 0, kernels.BLOCK: 0}
        want[path] = n
        assert sets[k] == want, (k, sets)
    f64, ref = _lattice_f64(
        lpb, lpe, al, ll, dv, valid,
        {"alphas": a_k, "betas": b_k, "ad": ad_k, "bd": bd_k,
         "walk a": fa, "walk ad": fad, "walk b": fb, "walk bd": fbd},
        label)
    errs = {"alphas": _rel_err(a_k, a_t),
            "betas": _rel_err(b_k, b_t, valid),
            "affine_rows": max(_rel_err(ad_k, ad_t),
                               _rel_err(bd_k, bd_t, valid)),
            "forward_walk alphas": _rel_err(fa, a_t),
            "forward_walk ad": _rel_err(fad, fad_t),
            "reverse_walk betas": _rel_err(fb, b_t, valid),
            "reverse_walk bd": _rel_err(fbd, fbd_t, valid)}
    if path == kernels.BLOCK:
        # the block set's walks normalise each cell's transition
        # probabilities (csrc/transducer.cu), the twin rows take them
        # from the stored alpha: held to float64 instead, at a fixed
        # bound and within twice the f32 twins' own error
        del errs["forward_walk ad"], errs["reverse_walk bd"]
        for k in ("ad", "bd"):
            walk, twin = f64[f"walk {k}"], f64[f"f32 twin {k}"]
            assert walk <= BLOCK_WALK_F64_TOL, (B, T, U, k, f64)
            assert walk <= max(2 * twin, 1e-6), (B, T, U, k, f64)
        fad_t, fbd_t = (ref[k].to(dev, torch.float32) for k in ("ad",
                                                               "bd"))
    print(f"phase {label}: [{B},{T},{U}] {path} set, err/(1+|x|) vs "
          f"twin: " + ", ".join(f"{k} {v:.3g} (tol {LAT_TOL[k]:g})"
                                 for k, v in errs.items()))
    for k, v in errs.items():
        assert v <= LAT_TOL[k], (B, T, U, k, v)
    abs_errs = {
        "alphas": (a_k - a_t).abs().max().item(),
        "betas": (b_k - b_t).abs()[valid].max().item(),
        "affine_rows": max((ad_k - ad_t).abs().max().item(),
                           (bd_k - bd_t).abs()[valid].max().item()),
        "forward_walk": max((fa - a_t).abs().max().item(),
                            (fad - fad_t).abs().max().item()),
        "reverse_walk": max((fb - b_t).abs()[valid].max().item(),
                            (fbd - fbd_t).abs()[valid].max().item())}
    return types.SimpleNamespace(
        acts=acts, labels=labels, al=al, ll=ll, dv=dv, lpb=lpb, lpe=lpe,
        path=path, errs=errs, f64=f64, abs_errs=abs_errs)


def _loss_grad(lat):
    """acts -> (total [B], delay [B], d/dacts) of the delay-transducer loss
    on ``lat``'s labels, lengths and delays (``_hold_lattice``), on the
    device and in the dtype of acts, rows weighted 1..B."""
    import torch
    from wav2vec_s_tpu_torch.ops.transducer import analytic

    def loss_grad(a):
        a = a.detach().clone().requires_grad_(True)
        total, prob, delay = analytic.delay_transducer_loss(
            a, lat.labels.to(a.device), lat.al.to(a.device),
            lat.ll.to(a.device), lat.dv.to(a.device))
        w = torch.arange(1, a.shape[0] + 1, device=a.device, dtype=a.dtype)
        (total * w).sum().backward()
        return total.detach(), delay.detach(), a.grad

    return loss_grad


def phase_lattice():
    """K5a, K5b, K6 (forward and reverse) and the two fused walks vs their
    twins on the kernel set that ``kernels.lattice_path`` picks, then the
    loss and its gradient through the kernels (CUDA) against float64 twins
    (CPU); the kernels timed beside the block set's design -> {name: row}:
    the warp set's fused walks at the full-width step's lattice (the first
    shape), the block set's at the long-target step's lattice (the
    fourth), where the main path runs each."""
    import types
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.ops import native
    from wav2vec_s_tpu_torch.ops.transducer import analytic, kernels, lattice
    from wav2vec_s_tpu_torch.tools.timing import graph_ms

    dev = torch.device("cuda")
    out = {}
    probe, chain = _step_probe()
    trips = _round_trips(chain)
    block_set = mock.patch.object(kernels, "lattice_path",
                                  lambda U: kernels.BLOCK)
    for i, (B, T, U, V) in enumerate(LATTICE_SHAPES):
        lat = _hold_lattice(dev, B, T, U, V, i, "lattice")
        acts, labels, al, ll, dv, lpb, lpe, path, abs_errs = (
            lat.acts, lat.labels, lat.al, lat.ll, lat.dv, lat.lpb, lat.lpe,
            lat.path, lat.abs_errs)
        loss_grad = _loss_grad(lat)
        if i in LAT_LOSS:
            _check_loss(loss_grad, acts, (B, T, U, V))
        del acts
        if i not in LAT_TIMED:
            continue

        acts = _lattice_inputs(dev, B, T, U, V, i)[0]
        step = lambda: loss_grad(acts)                          # noqa: E731
        twins = types.SimpleNamespace(
            alphas_and_expected_delay=lattice.alphas_and_expected_delay,
            betas_and_expected_delay_bwd=lattice.betas_and_expected_delay_bwd)
        ms = _cuda_ms(step, 10)
        n_kernels = _device_kernels(step)
        with block_set:
            block_ms = _cuda_ms(step, 10)
            block_kernels = _device_kernels(step)
        with mock.patch.object(analytic, "kernels", twins):
            plain_ms = _cuda_ms(step, 5)
        print(f"phase lattice: [{B},{T},{U},{V}] loss forward+backward: "
              f"kernels {ms:.4f} ms ({path} set; "
              f"{sum(n_kernels.values())} device kernels), the block set "
              f"{block_ms:.4f} ms "
              f"({sum(block_kernels.values())} device kernels), plain twins "
              f"{plain_ms:.4f} ms; kernels by name, against the block set: "
              f"{_kernel_diff(n_kernels, block_kernels) or 'the same'}")
        # Device time of each kernel alone: its C entry point on inputs and
        # lengths prepared here, LAT_LAUNCHES launches in one CUDA graph;
        # beside it the block set's C entry point.  Then the wrapper's host
        # time per eager call on either set, and the twin.
        coef = [torch.rand((B, T, U), device=dev) for _ in range(3)]
        lib = native.library()
        al32, ll32 = al.to(torch.int32), ll.to(torch.int32)
        res, res2 = torch.empty_like(lpb), torch.empty_like(lpb)

        def ptrs(*tensors):
            return [t.data_ptr() for t in tensors]

        def launches_of(call):          # call(stream) -> CUDA error
            def go():
                stream = torch.cuda.current_stream().cuda_stream
                for _ in range(LAT_LAUNCHES):
                    err = call(stream)
                    assert err == 0, err
            return go

        lens = (al32.data_ptr(), 0, ll32.data_ptr(), 0)
        dvs = (dv.data_ptr(), *dv.stride())
        warp = {
            "alphas": lambda st: lib.w2vs_lattice_warp_alphas(
                *ptrs(lpb, lpe, res), B, T, U, st),
            "betas": lambda st: lib.w2vs_lattice_warp_betas(
                *ptrs(lpb, lpe), *lens, res.data_ptr(), B, T, U, st),
            "affine_rows": lambda st: lib.w2vs_lattice_warp_affine_rows(
                *ptrs(*coef, res), B, T, U, 0, st),
            "forward_walk": lambda st: lib.w2vs_lattice_warp_alphas_delay(
                *ptrs(lpb, lpe), *dvs, *ptrs(res, res2), B, T, U, st),
            "reverse_walk": lambda st: lib.w2vs_lattice_warp_betas_delay(
                *ptrs(lpb, lpe), *lens, *dvs, *ptrs(res, res2), B, T, U,
                st)}
        block = {
            "alphas": launches_of(lambda st: lib.w2vs_transducer_alphas(
                *ptrs(lpb, lpe, res), B, T, U, st)),
            "betas": launches_of(lambda st: lib.w2vs_transducer_betas(
                *ptrs(lpb, lpe, al32, ll32, res), B, T, U, st)),
            "affine_rows": launches_of(
                lambda st: lib.w2vs_transducer_affine_rows(
                    *ptrs(*coef, res), B, T, U, 0, st)),
            "forward_walk": launches_of(
                lambda st: lib.w2vs_transducer_alphas_delay(
                    *ptrs(lpb, lpe), *dvs, *ptrs(res, res2), B, T, U, st)),
            "reverse_walk": launches_of(
                lambda st: lib.w2vs_transducer_betas_delay(
                    *ptrs(lpb, lpe), *lens, *dvs, *ptrs(res, res2), B, T, U,
                    st))}
        per = {   # wrapper, twin, probe step kind, [B, T, U] arrays moved
            "alphas": (lambda: kernels.alphas(lpb, lpe),
                       lambda: lattice.alphas(lpb, lpe), LAE, 3),
            "betas": (lambda: kernels.betas(lpb, lpe, al, ll),
                      lambda: lattice.betas(lpb, lpe, al, ll), LAE, 3),
            "affine_rows": (lambda: kernels.affine_rows(*coef),
                            lambda: lattice.affine_rows(*coef), AFFINE, 4),
            "forward_walk": (
                lambda: kernels.alphas_and_expected_delay(lpb, lpe, dv),
                lambda: lattice.alphas_and_expected_delay(lpb, lpe, dv),
                FUSED, 5),
            "reverse_walk": (
                lambda: kernels.betas_and_expected_delay_bwd(
                    lpb, lpe, al, ll, dv),
                lambda: lattice.betas_and_expected_delay_bwd(
                    lpb, lpe, al, ll, dv), FUSED, 5)}
        steps = T + U - 1
        for name, (wrapper, twin, kind, n_arrays) in per.items():
            k_ms = (graph_ms(launches_of(warp[name]), LAT_LAUNCHES)
                    if path == kernels.WARP else None)
            with block_set:
                b_ms = graph_ms(block[name], LAT_LAUNCHES)
            h_ms = _host_ms(wrapper, 1, reps=20)
            with block_set:
                hb_ms = _host_ms(wrapper, 1, reps=20)
            t_ms = _cuda_ms(twin, 5)
            # bound: the larger of the bytes (every [B, T, U] f32 input read
            # once, every output written once) or operations (~10 per cell
            # of a log-space recursion, 4 of an affine one, 24 of the fused
            # walks) and the latency of T + U - 1 dependent steps, one step
            # the least of those the probe kernel measures for this
            # recursion (tools/lattice_step_probe.cu, B lattices,
            # PROBE_STEPS steps in one launch, the precise expf/log1pf):
            # heads in registers at one cell per lane (min(U, 32) columns)
            # and at the warp set's ceil(U / 32) columns per lane (where
            # the warp set takes U), and the block set's step at this U
            # (shared memory + block barrier).  More columns per lane can
            # beat one (the chain crosses a lane once per column group),
            # and the block set may be the faster at some U: the least of
            # the designs measured is what the card is known to do.  No
            # PyTorch call computes these recursions.
            probed = {"one cell per lane": _step_ms(probe, res, B,
                                                    min(U, 32), kind, True)}
            if U <= kernels.WARP_MAX_U:
                probed[f"the warp set's, {-(-U // 32)} columns per lane"] = (
                    _step_ms(probe, res, B, U, kind, True))
            probed["the block set's, shared memory + barrier"] = (
                _step_ms(probe, res, B, U, AFFINE if kind == FUSED else kind,
                         False))
            step_ms = min(probed.values())
            cells = B * T * U
            ops = {LAE: 10, AFFINE: 4, FUSED: 24}[kind]
            bound = _bound(4 * n_arrays * cells, ops * cells, "float32")
            if steps * step_ms >= bound[0]:
                bound = (steps * step_ms, "latency")
            design = "; ".join(f"{k} {v * 1e6:.1f} ns -> {steps * v:.5f} ms"
                               for k, v in probed.items())
            trip = ""
            if name == "affine_rows":
                trip = ("; one dependent global load (load chain): "
                        + ", ".join(f"{k} {v:.1f} ns"
                                    for k, v in trips.items()))
            kernel = (f"{k_ms:.5f} ms, the block set's "
                      if k_ms is not None else "")
            print(f"phase lattice: [{B},{T},{U}] {name}: kernel {kernel}"
                  f"{b_ms:.5f} ms (device time per call, {LAT_LAUNCHES} "
                  f"calls in one CUDA graph), the wrapper's host time "
                  f"{h_ms:.4f} ms per eager call ({path} set; the block "
                  f"set {hb_ms:.4f}), plain twin {t_ms:.4f} ms; bound "
                  f"{bound[0]:.5f} ms by {bound[1]} ({steps} dependent "
                  f"steps x {step_ms * 1e6:.1f} ns, the least step of: "
                  f"{design}){trip}")
            if name.endswith("walk") and i in (0, 3):
                out[name + ("_block" if i else "")] = _row(
                    abs_errs[name], k_ms if i == 0 else b_ms, t_ms, bound,
                    None)
    return out


def _vocab(size):
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    v = Dictionary()
    for i in range(size - v.nspecial):
        v.add_symbol(f"w{i}")
    return v


def _clips(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.1 for n in lengths]


def _tiny_model(attention_impl="dense", dtype="float32"):
    """tests/test_caat.py dims, random weights from seed 0."""
    import torch
    from wav2vec_s_tpu_torch.models import Wav2Vec2Config
    from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
    from wav2vec_s_tpu_torch.models.modules import random_init_

    w2v = Wav2Vec2Config(
        conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
        encoder_layers=2, encoder_embed_dim=24, encoder_ffn_embed_dim=48,
        encoder_attention_heads=4, main_context=4, right_context=2,
        attention_impl=attention_impl, dtype=dtype)
    caat = CaatConfig(
        dtype=dtype, vocab_size=30, decoder_layers=2, decoder_embed_dim=24,
        decoder_ffn_embed_dim=48, decoder_attention_heads=4,
        jointer_layers=2, jointer_embed_dim=24, jointer_ffn_embed_dim=48,
        jointer_attention_heads=4)
    model = random_init_(W2V2CaatModel(w2v, caat),
                         torch.Generator().manual_seed(0))
    return w2v, caat, model


TINY_KW = dict(max_len=256, max_emit_per_chunk=4, t_cap=640,
               blocks_per_step=2)


def phase_parity():
    """Tiny model: CUDA decode == CPU decode."""
    from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder

    w2v, caat, model = _tiny_model()
    vocab, wavs = _vocab(caat.vocab_size), _clips((6400, 9600, 12800))
    out = {}
    for dev in ("cpu", "cuda"):
        dec = CachedFusedGreedyDecoder(model.to(dev), vocab, w2v, **TINY_KW)
        out[dev] = dec.decode_corpus(wavs)
    words = [len(d) for d in out["cuda"][1]]
    print(f"phase parity: tiny decode cuda == cpu: "
          f"{out['cuda'] == out['cpu']} (words per stream {words})")
    assert out["cuda"] == out["cpu"]
    assert sum(words) > 0


def phase_oneshot_parity():
    """Tiny model, flash attention (dh 6): the one-shot decode on CUDA ==
    on the CPU == the cached decode on CUDA."""
    from wav2vec_s_tpu_torch.stream.batched import (
        CachedFusedGreedyDecoder, OneShotCorpusDecoder)

    w2v, caat, model = _tiny_model("flash")
    vocab, wavs = _vocab(caat.vocab_size), _clips((6400, 9600, 12800))
    out = {}
    for dev in ("cpu", "cuda"):
        dec = OneShotCorpusDecoder(model.to(dev), vocab, w2v, **TINY_KW)
        out[dev] = dec.decode_corpus(wavs)
    cached = CachedFusedGreedyDecoder(model, vocab, w2v, **TINY_KW)
    out["cached"] = cached.decode_corpus(wavs)
    words = [len(d) for d in out["cuda"][1]]
    print(f"phase one-shot parity: tiny one-shot cuda == cpu: "
          f"{out['cuda'] == out['cpu']}, == cached cuda: "
          f"{out['cuda'] == out['cached']} (words per stream {words})")
    assert out["cuda"] == out["cpu"] == out["cached"]
    assert sum(words) > 0


BEAM_TINY_KW = dict(beam_size=3, inter_beam=1, max_steps=5, max_len=64,
                    eager=True, t_cap=64)
HOST_GEN_BEAM, HOST_CLIPS_SEED = 2.0, 2
BEAM_DECODERS = ("BatchedBeamStreamingDecoder", "OneShotBeamDecoder",
                 "FusedBeamStreamingDecoder", "FusedOneShotBeamDecoder")


def _grid_clips(w2v, chunks, seed=0):
    """Seeded noise whose lengths land on the chunk grid of ``w2v``: one
    clip of ``n * main_context + right_context`` frames per entry."""
    from wav2vec_s_tpu_torch.models.feature_extractor import (
        conv_receptive_stride)

    rf, hop = conv_receptive_stride(w2v.conv_feature_layers)
    return _clips([(n * w2v.main_context + w2v.right_context - 1) * hop + rf
                   for n in chunks], seed)


def _host_search(model, w2v, vocab, wav, beam, max_steps, gen_beam):
    """The host searcher (stream/searcher.py over stream/engine.py) on the
    chunk grid -> words."""
    from wav2vec_s_tpu_torch.models.feature_extractor import (
        conv_output_length, conv_receptive_stride)
    from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
    from wav2vec_s_tpu_torch.stream.searcher import (
        StreamingTransducerSearcher)

    rf, hop = conv_receptive_stride(w2v.conv_feature_layers)
    mc, rc = w2v.main_context, w2v.right_context
    window, stride = (mc + rc - 1) * hop + rf, mc * hop
    n_chunks = (conv_output_length(len(wav), w2v.conv_feature_layers)
                - rc) // mc
    lens = [min(k * stride + window, len(wav)) for k in range(n_chunks)]
    engine = StreamingEngine(model, main_context=mc, right_context=rc,
                             audio_buckets=sorted(set(lens)),
                             token_buckets=[8, 16, 32, 64])
    searcher = StreamingTransducerSearcher(engine, vocab, eager=True)
    state, words = searcher.init_state(), []
    for k, n in enumerate(lens):
        state, ws = searcher.search(
            state, wav[:n], k == n_chunks - 1, intra_beam=beam, inter_beam=1,
            gen_beam=gen_beam, read_step=mc, max_steps=max_steps)
        words.extend(ws)
    return words


def phase_beam_parity():
    """Tiny model: the four beam decoders on CUDA == on the CPU; batched ==
    the host searcher on CUDA; tie order on CUDA.  Returns whether the
    fused one-shot texts equal the fused streaming texts in bfloat16."""
    import torch
    from wav2vec_s_tpu_torch.stream import beam_batched

    dev = torch.device("cuda")
    # ties: the first maximum, the lowest index among equals
    for value in (float("-inf"), 0.25):
        x = torch.full((4, 5, 300), value, device=dev)
        assert not x.argmax(-1).any()
        x[..., 130] = x[..., 7] = 1.0
        assert (x.argmax(-1) == 7).all()
        flat = x.reshape(20, 300)
        want = torch.tensor([7, 130, 0, 1, 2], device=dev).expand(20, 5)
        assert torch.equal(torch.sort(flat, dim=1, descending=True,
                                      stable=True)[1][:, :5], want)
        assert torch.equal(torch.argsort(-flat, dim=1, stable=True)[:, :5],
                           want)
        # (past a row's last finite value the hierarchical picks are -inf
        # and their indices carry no meaning)
        n = 5 if value > 0 else 2
        i = beam_batched._top_b_per_row(x, 5)[1]
        assert torch.equal(i[..., :n], want.reshape(4, 5, 5)[..., :n])
    print("phase beam parity: argmax, stable sort and the hierarchical "
          "top-B take the lowest index among equals on the card (-inf and "
          "equal rows)")

    chunks = (6, 4, 6, 3)
    words = {}
    for name in BEAM_DECODERS:
        impl = "flash" if "OneShot" in name else "dense"
        w2v, caat, model = _tiny_model(impl)
        vocab, wavs = _vocab(caat.vocab_size), _grid_clips(w2v, chunks)
        out = {}
        for d in ("cpu", "cuda"):
            dec = getattr(beam_batched, name)(model.to(d), vocab, w2v,
                                              gen_beam=2.0, **BEAM_TINY_KW)
            dec.transfer_dtype = "int16"
            out[d] = dec.decode_corpus(wavs)
        words[name] = [len(x) for x in out["cuda"][1]]
        print(f"phase beam parity: tiny {name} ({impl}) cuda == cpu: "
              f"{out['cuda'] == out['cpu']} (words per stream "
              f"{words[name]})")
        assert out["cuda"] == out["cpu"], name
        assert min(words[name]) > 0

    # batched == the host searcher, both on the card: streams of one
    # length (in a mixed corpus a shorter stream learns of its end one
    # chunk later than the host searcher is told), at a gen_beam where no
    # kept row is shorter than a pool survivor (the host searcher then
    # appends past that row's padding; see
    # tests/test_torch_port_beam_decoders.py), which holds on these clips
    w2v, caat, model = _tiny_model()
    model = model.to(dev)
    vocab, wavs = _vocab(caat.vocab_size), _grid_clips(w2v, (5, 5, 5),
                                                        seed=HOST_CLIPS_SEED)
    dec = beam_batched.BatchedBeamStreamingDecoder(
        model, vocab, w2v, gen_beam=HOST_GEN_BEAM, **BEAM_TINY_KW)
    texts, _ = dec.decode_corpus(wavs)
    for wav, text in zip(wavs, texts):
        want = _host_search(model, w2v, vocab, wav, BEAM_TINY_KW["beam_size"],
                            BEAM_TINY_KW["max_steps"], HOST_GEN_BEAM)
        assert text.split() == want, (text, want)
    print(f"phase beam parity: batched == host searcher on the card "
          f"(gen_beam {HOST_GEN_BEAM}): True (words per stream "
          f"{[len(t.split()) for t in texts]})")

    # bfloat16: do the two fused decoders still agree?  (they run different
    # encoders: chunk attention per step vs one flash pass)
    texts = {}
    for name in BEAM_DECODERS[2:]:
        impl = "flash" if "OneShot" in name else "dense"
        w2v, caat, model = _tiny_model(impl, dtype="bfloat16")
        dec = getattr(beam_batched, name)(
            model.to(dev), _vocab(caat.vocab_size), w2v, gen_beam=2.0,
            **BEAM_TINY_KW)
        texts[name] = dec.decode_corpus(_grid_clips(w2v, chunks))[0]
    same = texts[BEAM_DECODERS[2]] == texts[BEAM_DECODERS[3]]
    print(f"phase beam parity: tiny bfloat16 fused one-shot texts == fused "
          f"streaming texts: {same}")
    return same


def _base_model(dev, attention_impl="dense"):
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)
    from wav2vec_s_tpu_torch.models.modules import random_init_
    import torch

    w2v = wav2vec_s_base_config(dtype="bfloat16",
                                attention_impl=attention_impl)
    caat = caat_base_config(dtype="bfloat16")
    with dev:
        model = W2V2CaatModel(w2v, caat)
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    return w2v, caat, model


def _timed_corpora(dec, wavs, corpora=CORPORA):
    """``corpora`` timed decodes, staging corpus k+1 before decoding corpus
    k (bench.py's pattern); returns (times, last texts, last delays)."""
    staged = dec.stage(wavs)
    times = []
    for i in range(corpora):
        t = time.perf_counter()
        nxt = dec.stage(wavs) if i + 1 < corpora else None
        texts, delays = dec.decode_corpus(staged)
        times.append(time.perf_counter() - t)
        staged = nxt
    return times, texts, delays


def _k7_per_corpus(dec, wavs, n_chunks, counts):
    """K7's launches in the timed corpora of a decoder, whose emission loop
    replays CUDA graphs that its wrapper's counter cannot see: the wrapper
    counts only the eager bos step that resets the LM before each
    corpus; one more corpus under torch.profiler must run (jointer + LM
    layers) x ``max_emit`` K7 kernels a chunk and that step's;
    ``counts["decode_attention"]`` becomes CORPORA times them."""
    caat = dec.model.cfg
    per_chunk = dec.max_emit * (caat.jointer_layers + caat.decoder_layers)
    assert counts["decode_attention"] == CORPORA * caat.decoder_layers, (
        counts)
    kernels = _device_kernels(lambda: dec.decode_corpus(wavs))
    n = sum(c for k, c in kernels.items() if "decode_attention" in k)
    assert n == n_chunks * per_chunk + caat.decoder_layers, (
        n, n_chunks, per_chunk)
    counts["decode_attention"] = CORPORA * n
    return (f"K7 {CORPORA * n} = {CORPORA} corpora x ({n_chunks} chunks x "
            f"{per_chunk} in graph replays, counted by torch.profiler, + "
            f"{caat.decoder_layers} eager in the LM's reset)")


def phase_full(card):
    """Base + CAAT base, bf16, the cached greedy agent at ds2."""
    import torch
    from wav2vec_s_tpu_torch.stream import caat_step
    from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder

    dev = torch.device("cuda")
    t = time.perf_counter()
    w2v, caat, model = _base_model(dev)
    S = int(SECONDS * 16000)
    frames = (S - 400) // 320 + 1
    t_cap = -(-(frames + w2v.right_context) // 128) * 128       # 512
    dec = CachedFusedGreedyDecoder(model, _vocab(caat.vocab_size), w2v,
                                   max_len=256, max_emit_per_chunk=4,
                                   t_cap=t_cap, blocks_per_step=2)
    dec.transfer_dtype = "int16"
    wavs = _clips([S] * N_STREAMS)
    print(f"phase full: model + decoder ready in "
          f"{time.perf_counter() - t:.1f} s")
    dec.decode_corpus(wavs)                                     # warm-up

    enc = dec._encoder(N_STREAMS)
    n_chunks = max((frames - w2v.right_context) // enc.n_main, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, texts, delays = _timed_corpora(dec, wavs)
    counts, sets = _counts(), _set_paths()
    launches = counts["chunk_cache_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = w2v.encoder_layers * n_chunks * CORPORA
    k7 = _k7_per_corpus(dec, wavs, n_chunks, counts)
    print(f"phase full: kernel launches {counts} (K1 expected {want} = "
          f"{w2v.encoder_layers} layers x {n_chunks} chunks x {CORPORA}, "
          f"all on the tensor-core kernel: {sets['K1']}; {k7})")
    assert launches == want, (launches, want)
    _on_tensor_cores(sets, {"K1": want})
    assert any(texts), "decoder emitted nothing"
    end_ms = (S + enc.window) / 16.0
    for d in delays:
        assert d == sorted(d) and all(0 < x <= end_ms for x in d)

    # outputs are finite: one encoder step and one jointer step at full width
    state = enc.init()
    win = dec.stage(wavs)[2][:, :enc.window].float() / 32768.0
    state = enc.step(state, win)
    x = state.out_cache[:state.t_main]
    jk, jv = caat_step.jointer_kv(dec.model, dec.model.cfg, x)
    lm = caat_step.lm_init(dec.model, dec.model.cfg, N_STREAMS, 8)
    lp = caat_step.jointer_step(dec.model, dec.model.cfg, lm.h_last, jk, jv,
                                torch.full((N_STREAMS,), x.shape[0],
                                           device=dev))
    assert win.shape == (N_STREAMS, enc.window)
    assert torch.isfinite(x).all() and torch.isfinite(lp).all()
    assert lp.shape == (N_STREAMS, caat.vocab_size)

    rate = N_STREAMS * SECONDS / min(times)
    print(f"phase full: {N_STREAMS} streams x {SECONDS:g} s, corpus times "
          f"{['%.4f' % s for s in times]} s -> {rate:.2f} audio-sec/s "
          f"(best corpus), peak memory {peak_gb:.3f} GB, words in the last "
          f"corpus {sum(len(d) for d in delays)} [{card}]")
    return counts


def phase_oneshot_full(card):
    """Base + CAAT base, bf16, flash attention: the one-shot corpus decoder
    at ds2 (bench.py's oneshot_corpus_throughput_ds2 configuration)."""
    import torch
    from wav2vec_s_tpu_torch.stream import caat_step
    from wav2vec_s_tpu_torch.stream.batched import OneShotCorpusDecoder

    dev = torch.device("cuda")
    t = time.perf_counter()
    w2v, caat, model = _base_model(dev, attention_impl="flash")
    S = int(SECONDS * 16000)
    frames = (S - 400) // 320 + 1
    t_cap = -(-(frames + w2v.right_context) // 128) * 128       # 512
    dec = OneShotCorpusDecoder(model, _vocab(caat.vocab_size), w2v,
                               max_len=256, max_emit_per_chunk=4,
                               t_cap=t_cap, blocks_per_step=2)
    dec.transfer_dtype = "int16"
    dec.encode_batch = ENCODE_BATCH
    wavs = _clips([S] * ONESHOT_STREAMS)
    del model
    print(f"phase one-shot full: model + decoder ready in "
          f"{time.perf_counter() - t:.1f} s")
    dec.decode_corpus(wavs)                                     # warm-up

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, texts, delays = _timed_corpora(dec, wavs)
    counts, flash_paths = _counts(), _set_paths()
    launches = counts["blockwise_flash_attention_packed"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_sub = ONESHOT_STREAMS // ENCODE_BATCH
    want = w2v.encoder_layers * n_sub * CORPORA
    enc = dec._encoder(ONESHOT_STREAMS)
    k7 = _k7_per_corpus(dec, wavs, max(
        (frames - w2v.right_context) // enc.n_main, 1), counts)
    print(f"phase one-shot full: kernel launches {counts} (K2 expected "
          f"{want} = {w2v.encoder_layers} layers x {n_sub} sub-batches x "
          f"{CORPORA}; {k7}); by kernel set {flash_paths}")
    assert launches == want, (launches, want)
    _on_tensor_cores(flash_paths, {"K2": want, "K3": 0})
    assert any(texts), "decoder emitted nothing"
    enc = dec._encoder(ONESHOT_STREAMS)
    end_ms = (S + enc.window) / 16.0
    for d in delays:
        assert d == sorted(d) and all(0 < x <= end_ms for x in d)

    # outputs are finite: one encode sub-batch and one jointer step at full
    # width, at the decoder's shapes
    n_chunks = (frames - w2v.right_context) // enc.n_main
    t_frames = n_chunks * enc.n_main + w2v.right_context            # 488
    n_samples = (t_frames - 1) * enc.hop + enc.rf
    au = dec.stage(wavs[:ENCODE_BATCH])[2][:, :n_samples].float() / 32768.0
    e, _ = dec.model.encode(au)
    assert e.shape == (ENCODE_BATCH, t_frames, w2v.encoder_embed_dim)
    jk, jv = caat_step.jointer_kv(dec.model, dec.model.cfg,
                                  e.transpose(0, 1).contiguous())
    lm = caat_step.lm_init(dec.model, dec.model.cfg, ENCODE_BATCH, 8)
    lp = caat_step.jointer_step(dec.model, dec.model.cfg, lm.h_last, jk, jv,
                                torch.full((ENCODE_BATCH,), t_frames,
                                           device=dev))
    assert torch.isfinite(e).all() and torch.isfinite(lp).all()
    assert lp.shape == (ENCODE_BATCH, caat.vocab_size)

    rate = ONESHOT_STREAMS * SECONDS / min(times)
    print(f"phase one-shot full: {ONESHOT_STREAMS} streams x {SECONDS:g} s, "
          f"corpus times {['%.4f' % s for s in times]} s -> {rate:.2f} "
          f"audio-sec/s (best corpus), peak memory {peak_gb:.3f} GB, words "
          f"in the last corpus {sum(len(d) for d in delays)} [{card}]")
    return counts


BEAM_STREAMS, BEAM_CORPORA = 64, 3
BEAM_KW = dict(beam_size=5, inter_beam=1, max_steps=8, max_len=64,
               eager=True, blocks_per_step=2)


def _device_reads(dec, wavs):
    """The synchronizing device operations of one ``decode_corpus`` of a
    staged corpus -> (count, {innermost file:line of this checkout that
    led to each}), as ``torch.cuda.set_sync_debug_mode("warn")`` reports
    them."""
    import traceback
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sites = []

    def note(message, category, filename, lineno, file=None, line=None):
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(root)
                and os.path.abspath(f.filename) != os.path.abspath(__file__)]
        f = ours[-1] if ours else None
        sites.append(f"{os.path.basename(f.filename)}:{f.lineno}" if f
                     else f"{os.path.basename(filename)}:{lineno}")

    staged = dec.stage(wavs)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown, warnings.showwarning = warnings.showwarning, note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            dec.decode_corpus(staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    return len(sites), sorted(set(sites))


def _beam_decoder(name, impl):
    """Base + CAAT base, bf16, the fused beam decoder ``name`` at the
    configuration of bench.py's beam legs -> (w2v, caat, decoder, S)."""
    import torch
    from wav2vec_s_tpu_torch.stream import beam_batched

    w2v, caat, model = _base_model(torch.device("cuda"), attention_impl=impl)
    S = int(SECONDS * 16000)
    frames = (S - 400) // 320 + 1
    t_cap = -(-(frames + w2v.right_context) // 128) * 128       # 512
    dec = getattr(beam_batched, name)(model, _vocab(caat.vocab_size), w2v,
                                      t_cap=t_cap, **BEAM_KW)
    dec.transfer_dtype = "int16"
    dec.encode_batch = ENCODE_BATCH
    return w2v, caat, dec, S


def phase_beam_full(card, same_in_bf16):
    """Base + CAAT base, bf16, intra-beam 5: the fused streaming beam
    decoder (K1) and the fused one-shot beam decoder (K2, flash) ->
    {path: launch counts}."""
    import torch

    paths, texts_of = {}, {}
    for name, impl, path in (
            ("FusedBeamStreamingDecoder", "dense", "beam_streaming"),
            ("FusedOneShotBeamDecoder", "flash", "beam_oneshot")):
        t = time.perf_counter()
        w2v, caat, dec, S = _beam_decoder(name, impl)
        wavs = _clips([S] * BEAM_STREAMS)
        print(f"phase beam full: {name}: model + decoder ready in "
              f"{time.perf_counter() - t:.1f} s")
        dec.decode_corpus(wavs)                                 # warm-up
        enc = dec._encoder(BEAM_STREAMS)
        frames = (S - 400) // 320 + 1
        n_chunks = max((frames - w2v.right_context) // enc.n_main, 1)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        before = dec.iterations_run
        times, texts, delays = _timed_corpora(dec, wavs, BEAM_CORPORA)
        counts, sets = _counts(), _set_paths()
        iterations = dec.iterations_run - before
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if impl == "dense":
            want = {"K1": w2v.encoder_layers * n_chunks * BEAM_CORPORA,
                    "K2": 0}
            said = (f"K1 expected {want['K1']} = {w2v.encoder_layers} layers"
                    f" x {n_chunks} chunks x {BEAM_CORPORA}, K2 0")
        else:
            n_sub = BEAM_STREAMS // ENCODE_BATCH
            want = {"K1": 0,
                    "K2": w2v.encoder_layers * n_sub * BEAM_CORPORA}
            said = (f"K2 expected {want['K2']} = {w2v.encoder_layers} layers"
                    f" x {n_sub} sub-batches x {BEAM_CORPORA}, K1 0")
        print(f"phase beam full: {name}: kernel launches {counts} ({said}); "
              f"by kernel set {sets}")
        assert counts["chunk_cache_attention"] == want["K1"], counts
        assert counts["blockwise_flash_attention_packed"] == want["K2"], counts
        _on_tensor_cores(sets, dict(want, K3=0))
        assert any(texts), "beam decoder emitted nothing"
        end_ms = (S + enc.window) / 16.0
        for text, d in zip(texts, delays):
            assert len(d) == len(text.split())
            assert d == sorted(d) and all(0 < x <= end_ms for x in d)
        texts_of[name] = texts
        paths[path] = counts

        # reads from the device in one decode of a staged corpus with the
        # early-stop read off, at two corpus lengths: none may sit in the
        # chunk loop (one read per chunk would make the counts differ by
        # the difference in chunks)
        half = _clips([S // 2] * BEAM_STREAMS)
        dec.decode_corpus(half)                                 # warm-up
        every, dec.stop_check_every = dec.stop_check_every, 0
        reads = {n: _device_reads(dec, w)
                 for n, w in ((n_chunks, wavs), (n_chunks // 2, half))}
        dec.stop_check_every = every
        print(f"phase beam full: {name}: synchronizing device operations in "
              f"one decode of a staged corpus, early-stop read off: "
              + ", ".join(f"{c} at {n} chunks" for n, (c, _) in reads.items())
              + f" (at {reads[n_chunks][1]}: the schedule's three uploads, "
              f"the block layout's uploads of a one-shot encode, the one "
              f"read of the best rows)")
        (c_long, _), (c_short, _) = reads.values()
        assert abs(c_long - c_short) < n_chunks - n_chunks // 2, reads

        rates = [BEAM_STREAMS * SECONDS / s for s in times]
        print(f"phase beam full: {name}: {BEAM_STREAMS} streams x "
              f"{SECONDS:g} s, beam {BEAM_KW['beam_size']}, corpus times "
              f"{['%.4f' % s for s in times]} s -> {max(rates):.2f} "
              f"audio-sec/s (best corpus; the others "
              f"{['%.2f' % r for r in sorted(rates)[:-1]]}), "
              f"{iterations} beam iterations of the {n_chunks} chunks x "
              f"{BEAM_KW['max_steps']} x {BEAM_CORPORA} = "
              f"{n_chunks * BEAM_KW['max_steps'] * BEAM_CORPORA} at most "
              f"(early-stop read every {dec.stop_check_every or 'never'})"
              f", peak memory {peak_gb:.3f} GB, words in the last corpus "
              f"{sum(len(d) for d in delays)} [{card}]")

        if impl == "dense":
            # the early-stop read: off, every iteration, every fourth; and
            # under a blank bias that ends every block early (what a read
            # can win): best of two corpora each, taken in turns
            stops, every0 = {}, dec.stop_check_every
            for bias in (0.0, 20.0):
                dec.bos_bias = bias
                for every in (0, 1, 4, 0, 1, 4):
                    dec.stop_check_every = every
                    before = dec.iterations_run
                    t_e = _timed_corpora(dec, wavs, 1)[0][0]
                    it = dec.iterations_run - before
                    best = stops.get((bias, every), (t_e, it))[0]
                    stops[bias, every] = (min(best, t_e), it)
            dec.bos_bias, dec.stop_check_every = 0.0, every0
            print("phase beam full: early-stop read, best corpus s "
                  "(iterations per corpus): "
                  + "; ".join(
                      f"bos_bias {b:g} read every {e or 'never'}: "
                      f"{t_:.4f} ({it})"
                      for (b, e), (t_, it) in sorted(stops.items()))
                  + f" [{card}]")
        del dec
        torch.cuda.empty_cache()

    a, b = (texts_of[n] for n in ("FusedBeamStreamingDecoder",
                                  "FusedOneShotBeamDecoder"))
    share = sum(x == y for x, y in zip(a, b)) / len(a)
    print(f"phase beam full: fused one-shot text == fused streaming text "
          f"for {share:.3f} of the streams (the tiny bfloat16 case: "
          f"{same_in_bf16}; the encoders round differently in bfloat16, so "
          f"near-ties may order differently)")
    return paths


TRAIN_B, TRAIN_U, TRAIN_WINDOW = 8, 40, 5
LONG_U = 299               # the long-target step: U + 1 = 300 > 256


def _train_batch(B, S, U, vocab, eos, dev, seed=0):
    """Seeded noise audio and random targets with eos last
    (bench.py:333-337)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    src = torch.randn((B, S), generator=g)
    tgt = torch.randint(4, vocab, (B, U), generator=g)
    tgt[:, -1] = eos
    return {"source": src.to(dev), "targets": tgt.to(dev)}


def _tiny_train_model(dropout: bool, attention_impl="dense"):
    """The tiny dims, random weights from seed 0; the recipe's dropouts
    (rand_pos 30 scaled to the tiny U) or none at all."""
    import dataclasses

    import torch
    from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
    from wav2vec_s_tpu_torch.models.modules import random_init_

    w2v, caat, _ = _tiny_model(attention_impl)
    caat = dataclasses.replace(caat, transducer_downsample=8,
                               tokens_per_step=200)
    if not dropout:
        w2v = dataclasses.replace(w2v, dropout=0.0, attention_dropout=0.0,
                                  activation_dropout=0.0,
                                  encoder_layerdrop=0.0)
        caat = dataclasses.replace(caat, dropout=0.0, attention_dropout=0.0,
                                   activation_dropout=0.0,
                                   rand_pos_decoder=0)
    model = random_init_(W2V2CaatModel(w2v, caat),
                         torch.Generator().manual_seed(0))
    return w2v, caat, model


def _trainer(model, caat, cfg, **kw):
    from wav2vec_s_tpu_torch.train.optim import build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    opt = build_optimizer(cfg)
    state = TrainState.create(model, opt)
    return state, make_train_step(make_caat_loss_fn(model, caat, **kw), opt)


def _two_updates_cpu_vs_cuda(attention_impl):
    """Tiny model, dropout off: two updates on the card (kernels) against
    the same updates on the CPU (twins): loss, grad norm, every parameter.
    Returns (cpu launches, cuda launches, the line to print)."""
    import torch
    from wav2vec_s_tpu_torch.train.optim import OptimConfig

    cfg = OptimConfig(lr=1e-3, clip_norm=2.0, weight_decay=0.01,
                      lr_scheduler="inverse_sqrt", warmup_updates=2)
    runs = {}
    for dev in ("cpu", "cuda"):
        w2v, caat, model = _tiny_train_model(False, attention_impl)
        model.to(dev)
        state, step = _trainer(model, caat, cfg)
        gen = torch.Generator().manual_seed(0)
        _reset_counts()
        logs = []
        for i in range(2):
            batch = _train_batch(3, 2400, 6, caat.vocab_size, caat.eos, dev,
                                 seed=i)
            state, out = step(state, batch, gen)
            logs.append({k: float(out[k]) for k in
                         ("loss_total", "grad_norm", "skipped")})
        runs[dev] = (logs, {k: v.detach().cpu() for k, v in
                            model.state_dict().items()}, _counts())
    (lc, pc, nc), (lg, pg, ng) = runs["cpu"], runs["cuda"]
    param_err = max((pc[k] - pg[k]).abs().max().item() for k in pc)
    for a, b in zip(lc, lg):
        assert abs(a["loss_total"] - b["loss_total"]) <= 1e-5 * abs(
            a["loss_total"]), (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * a[
            "grad_norm"], (a, b)
        assert a["skipped"] == b["skipped"] == 0.0
    assert param_err <= 1e-2 * cfg.lr, param_err
    assert all(v == 0 for v in nc.values()), nc
    assert ng["transducer_forward_walk"] > 0 and ng["hw_dropout"] == 0
    assert ng["transducer_reverse_walk"] > 0
    assert ng["transducer_alphas"] == ng["transducer_betas"] == ng[
        "transducer_affine_rows"] == 0
    line = (f"tiny, {attention_impl} attention, dropout off, 2 updates: cuda "
            f"(kernels) == cpu (twins): loss "
            f"{[x['loss_total'] for x in lg]} vs "
            f"{[x['loss_total'] for x in lc]} (rtol 1e-5), grad norm "
            f"{[x['grad_norm'] for x in lg]} vs "
            f"{[x['grad_norm'] for x in lc]} (rtol 1e-4), params max abs "
            f"diff {param_err:.3g} (tol {1e-2 * cfg.lr:g}); cuda launches "
            f"{ng}")
    return nc, ng, line


def phase_train_flash_parity():
    """Tiny flash training on the card equals the CPU over 2 updates; then,
    with the recipe's dropouts on, one forward and backward on flash
    attention equals the one on dense attention on the card under one
    seed (the kernels draw the mask the dense branch drops with)."""
    import torch
    from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn

    _, ng, line = _two_updates_cpu_vs_cuda("flash")
    layers, n_steps = 2, 2
    assert ng["blockwise_flash_attention_packed"] == layers * n_steps, ng
    assert ng["blockwise_flash_attention_bwd"] == layers * n_steps, ng
    print(f"phase train flash parity: {line}")

    runs = {}
    for impl in ("flash", "dense"):
        w2v, caat, model = _tiny_train_model(True, impl)
        model.to("cuda")
        batch = _train_batch(3, 2400, 6, caat.vocab_size, caat.eos, "cuda")
        _reset_counts()
        loss, _, _ = make_caat_loss_fn(model, caat)(
            batch, torch.Generator().manual_seed(11), 0)
        loss.backward()
        runs[impl] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()}, _counts())
    (lf, gf, nf), (ld, gd, nd) = runs["flash"], runs["dense"]
    top = max(g.abs().max().item() for g in gd.values() if g is not None)
    err = max((gf[k] - g).abs().max().item() for k, g in gd.items()
              if g is not None)
    assert all((gf[k] is None) == (g is None) for k, g in gd.items())
    kept = nf["blockwise_flash_attention_packed"]
    print(f"phase train flash parity: tiny, the recipe's dropouts on, one "
          f"seed: flash loss {lf:.6f} vs dense {ld:.6f} (rtol 1e-5), "
          f"gradients max |diff| / max |grad| {err / top:.3g} (tol 1e-4); "
          f"flash launches {nf}, dense launches {nd}")
    assert abs(lf - ld) <= 1e-5 * abs(ld), (lf, ld)
    assert err <= 1e-4 * top, (err, top)
    assert kept == nf["blockwise_flash_attention_bwd"] > 0
    assert nd["blockwise_flash_attention_packed"] == 0
    # the attention sites launch K4 forward and backward only when dense
    assert nd["hw_dropout"] - nf["hw_dropout"] == 2 * kept, (nf, nd)


def phase_train_parity():
    """Tiny model, dropout off: two updates on the card (kernels) equal the
    same updates on the CPU (twins): loss, grad norm, every parameter.
    Then a tiny overfit on the card with the recipe's dropouts on."""
    import torch
    from wav2vec_s_tpu_torch.train.optim import OptimConfig

    _, _, line = _two_updates_cpu_vs_cuda("dense")
    print(f"phase train parity: {line}")

    # a tiny overfit: 30 steps on one batch, the recipe's dropouts on
    w2v, caat, model = _tiny_train_model(dropout=True)
    model.to("cuda")
    state, step = _trainer(model, caat, OptimConfig(
        lr=2e-3, clip_norm=2.0, lr_scheduler="inverse_sqrt",
        warmup_updates=5))
    gen = torch.Generator().manual_seed(0)
    batch = _train_batch(3, 2400, 6, caat.vocab_size, caat.eos, "cuda")
    _reset_counts()
    per_token = []
    for _ in range(30):
        state, out = step(state, batch, gen)
        per_token.append(float(out["loss_total"]) / float(out["sample_size"]))
    first, last = np.mean(per_token[:5]), np.mean(per_token[-5:])
    launched = _counts()["hw_dropout"]
    print(f"phase train parity: tiny overfit, dropout on, 30 steps: loss "
          f"per token {first:.4f} (first 5) -> {last:.4f} (last 5), "
          f"K4 launches {launched}")
    assert np.isfinite(per_token).all() and last < 0.7 * first
    assert launched > 0


def phase_train_full(card):
    """wav2vec-S Base + CAAT base, bf16, dense attention, the recipe's
    dropouts on: B 8 x 10 s, U 40 (bench.py:306-350's shapes and optimizer):
    one warm step, then two timed windows of TRAIN_WINDOW steps with every
    launch count set to 0 before them."""
    import math
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import recipes
    from wav2vec_s_tpu_torch.train.optim import OptimConfig

    dev = torch.device("cuda")
    t = time.perf_counter()
    w2v = wav2vec_s_base_config(dtype="bfloat16", attention_impl="dense")
    caat = caat_base_config(dtype="bfloat16")
    with dev:
        model = W2V2CaatModel(w2v, caat)
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    S = int(SECONDS * 16000)
    batch = _train_batch(TRAIN_B, S, TRAIN_U, caat.vocab_size, caat.eos, dev)
    state, step = _trainer(model, caat, OptimConfig(lr=1e-4,
                                                    warmup_updates=100),
                           main_context=16, right_context=8)
    gen = torch.Generator().manual_seed(0)
    print(f"phase train full: model ready in {time.perf_counter() - t:.1f} s"
          f", {sum(p.numel() for p in model.parameters())} parameters")
    state, logs = step(state, batch, gen)                        # warm-up
    torch.cuda.synchronize()

    contexts = []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, all_logs = [], []
    with mock.patch.object(recipes, "DropoutContext",
                           recording_context(contexts=contexts)):
        for _ in range(2):
            t = time.perf_counter()
            for _ in range(TRAIN_WINDOW):
                state, logs = step(state, batch, gen)
                all_logs.append(logs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = 2 * TRAIN_WINDOW
    frames = (S - 400) // 320 + 1
    G = -(-frames // caat.transducer_downsample)
    chunk_b = max(1, min(TRAIN_B, caat.tokens_per_step
                         // (G * (TRAIN_U + 1))))
    n_chunks = math.ceil(TRAIN_B / chunk_b)
    # forward + checkpoint recompute run the forward fused walk, the
    # backward the reverse one, all on the warp set at U 41; each dropout
    # site launches once forward and once backward
    sites = sum(c.sites for c in contexts)
    want = {"transducer_forward_walk": 2 * n_chunks * n_steps,
            "transducer_reverse_walk": n_chunks * n_steps,
            "transducer_forward_walk_block": 0,
            "transducer_reverse_walk_block": 0,
            "transducer_alphas": 0, "transducer_betas": 0,
            "transducer_affine_rows": 0,
            "hw_dropout": 2 * sites,
            "chunk_cache_attention": 0,
            "blockwise_flash_attention_packed": 0,
            "blockwise_flash_attention_bwd": 0,
            "decode_attention": 0}
    per_step = {k: v / n_steps for k, v in counts.items()}
    print(f"phase train full: launches {counts} over {n_steps} steps "
          f"(per step {per_step}); expected {want} (G {G}, U+1 "
          f"{TRAIN_U + 1}, {n_chunks} chunk(s) of {chunk_b}; "
          f"{sites} dropout sites over {len(contexts)} steps)")
    assert counts == want, (counts, want)
    # 1 + 3 per kept encoder layer + 1 + 4 per LM layer + 4 per jointer layer
    fixed = 2 + 4 * (caat.decoder_layers + caat.jointer_layers)
    assert all(fixed <= c.sites <= fixed + 3 * w2v.encoder_layers
               for c in contexts)
    vals = [{k: float(v) for k, v in lg.items()} for lg in all_logs]
    assert all(math.isfinite(v["loss_total"]) and math.isfinite(
        v["grad_norm"]) and v["skipped"] == 0.0 for v in vals), vals
    ups = n_steps / sum(times)
    best = TRAIN_WINDOW / min(times)
    print(f"phase train full: B {TRAIN_B} x {SECONDS:g} s, U {TRAIN_U}, "
          f"window times {['%.4f' % x for x in times]} s -> {ups:.3f} "
          f"updates/s over all {n_steps} steps ({TRAIN_B * SECONDS * ups:.2f}"
          f" audio-sec/s; best window {best:.3f} updates/s, "
          f"{TRAIN_B * SECONDS * best:.2f} audio-sec/s), peak memory "
          f"{peak_gb:.3f} GB, loss "
          f"{vals[0]['loss_total']:.2f} -> {vals[-1]['loss_total']:.2f}, "
          f"grad norm {vals[-1]['grad_norm']:.3f}, skipped 0 [{card}]")

    # one step on targets past the warp set's U (CaatConfig allows 1024):
    # the loss runs the block set's fused walks, the forward one twice per
    # chunk (forward, recompute), the reverse one once
    long_b = _train_batch(TRAIN_B, S, LONG_U, caat.vocab_size, caat.eos, dev,
                          seed=1)
    chunk_b = max(1, min(TRAIN_B, caat.tokens_per_step
                         // (G * (LONG_U + 1))))
    n_chunks = math.ceil(TRAIN_B / chunk_b)
    _reset_counts()
    state, logs = step(state, long_b, gen)
    torch.cuda.synchronize()
    long_counts, sets = _counts(), _set_paths()
    lattice_counts = {k: v for k, v in long_counts.items()
                      if k.startswith("transducer")}
    want = {"transducer_forward_walk": 0, "transducer_reverse_walk": 0,
            "transducer_forward_walk_block": 2 * n_chunks,
            "transducer_reverse_walk_block": n_chunks,
            "transducer_alphas": 0, "transducer_betas": 0,
            "transducer_affine_rows": 0}
    print(f"phase train full: one step on targets of {LONG_U} labels (U+1 "
          f"{LONG_U + 1}, {n_chunks} chunk(s) of {chunk_b}): lattice "
          f"launches {lattice_counts}; expected {want}, all on the block "
          f"set; loss {float(logs['loss_total']):.2f}")
    assert lattice_counts == want, (lattice_counts, want)
    assert math.isfinite(float(logs["loss_total"]))
    assert float(logs["skipped"]) == 0.0
    return counts, long_counts, ups, peak_gb


CLI_WARM, CLI_TIMED, CLI_RESUMED, CLI_CLIPS, CLI_WORDS = 2, 10, 2, 16, 39


def _cli_corpus(root, n_clips, n_samples, vocab_size, n_words):
    """Seeded-noise wavs, an S2T tsv and a fairseq dict under ``root`` ->
    (tsv path, dict path)."""
    from wav2vec_s_tpu_torch.data.audio import write_wav
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(vocab_size - Dictionary().nspecial)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    lines = ["id\taudio\tn_frames\ttgt_text"]
    for i in range(n_clips):
        write_wav(root / f"utt{i}.wav",
                  rng.standard_normal(n_samples).astype(np.float32) * 0.1)
        text = " ".join(words[j] for j in rng.integers(0, len(words),
                                                       n_words))
        lines.append(f"utt{i}\t{root}/utt{i}.wav\t{n_samples}\t{text}")
    (root / "train.tsv").write_text("\n".join(lines) + "\n")
    return root / "train.tsv", root / "dict.txt"


def _run_cli(argv, n_layers, n_dec_layers):
    """One call of the trainer's entry point (bfloat16, full width) with
    every launch count set to 0 before it -> (counts, progress records with
    the host time of each, dropout contexts of its steps, peak GB).  Every
    flash launch must have run on the tensor-core kernels."""
    import io
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import cli, recipes
    from wav2vec_s_tpu_torch.utils.metrics import JsonProgress

    contexts, records = [], []

    class Timed(JsonProgress):
        def __init__(self, **kw):
            super().__init__(stream=io.StringIO(), **kw)

        def log(self, stats, step, tag="train"):
            torch.cuda.synchronize()
            records.append(dict(stats, step=step, tag=tag,
                                at=time.perf_counter()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with mock.patch.object(recipes, "DropoutContext",
                           recording_context(contexts=contexts)), \
            mock.patch.object(cli, "JsonProgress", Timed):
        cli.main(argv)
    torch.cuda.synchronize()
    counts = _counts()
    _on_tensor_cores(_set_paths(), {
        "K2": counts["blockwise_flash_attention_packed"],
        "K3": counts["blockwise_flash_attention_bwd"]})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # 1 + 3 per kept encoder layer + 1 + 4 per LM layer + 4 per jointer
    # layer dropout sites in a step
    fixed = 2 + 4 * n_dec_layers
    kept = [(c.sites - fixed) // 3 for c in contexts]
    assert all(0 <= k <= n_layers and fixed + 3 * k == c.sites
               for k, c in zip(kept, contexts)), [c.sites for c in contexts]
    return counts, records, contexts, kept, peak_gb


def phase_cli_full(card):
    """The training entry point at Base + CAAT base width, bf16, the
    recipe's dropouts, batches of 8 x 10 s: flash attention (12 updates, a
    checkpoint, a resumed call of 2 more), then dense attention through the
    same entry point."""
    import math
    import pathlib
    import tempfile

    import torch

    S = int(SECONDS * 16000)
    n_layers, n_dec = 12, 6 + 6
    total = CLI_WARM + CLI_TIMED
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        tsv, vocab = _cli_corpus(root, CLI_CLIPS, S, 10000, CLI_WORDS)
        print(f"phase cli full: {CLI_CLIPS} wavs of {SECONDS:g} s, tsv and "
              f"dict written in {time.perf_counter() - t:.1f} s")

        def argv(impl, max_update):
            return ["--device", "cuda", "run.task=caat",
                    f"run.save_dir={root}/ckpt_{impl}",
                    f"run.max_update={max_update}", "run.log_interval=1",
                    "run.save_interval_updates=0", "run.keep_last=1",
                    f"data.train_manifest={tsv}", f"data.vocab={vocab}",
                    f"data.max_tokens={TRAIN_B * S}",
                    f"data.max_sample_size={S}", "optim.lr=1e-4",
                    "optim.warmup_updates=100", "model.dtype=bfloat16",
                    f"model.attention_impl={impl}", "caat.dtype=bfloat16",
                    "caat.step_mode=constant"]

        for impl in ("flash", "dense"):
            t = time.perf_counter()
            counts, recs, ctxs, kept, peak_gb = _run_cli(argv(impl, total),
                                                         n_layers, n_dec)
            wall = time.perf_counter() - t
            assert [r["step"] for r in recs] == list(range(1, total + 1))
            assert all(math.isfinite(r["loss_total"]) and math.isfinite(
                r["grad_norm"]) and r["skipped"] == 0.0
                and "oom_skipped" not in r for r in recs), recs
            assert all(r["sample_size"] == TRAIN_B * (CLI_WORDS + 1)
                       for r in recs)
            # G 8 groups x (U 64 + 1): one chunk of the loss per step, its
            # fused walks on the warp set
            want = {"transducer_forward_walk": 2 * total,
                    "transducer_reverse_walk": total,
                    "transducer_forward_walk_block": 0,
                    "transducer_reverse_walk_block": 0,
                    "transducer_alphas": 0, "transducer_betas": 0,
                    "transducer_affine_rows": 0,
                    "chunk_cache_attention": 0, "decode_attention": 0}
            flash_calls = sum(kept) if impl == "flash" else 0
            want.update(
                blockwise_flash_attention_packed=flash_calls,
                blockwise_flash_attention_bwd=flash_calls,
                hw_dropout=2 * (sum(c.sites for c in ctxs) - flash_calls))
            on = (", K2 and K3 all on the tensor-core kernels"
                  if impl == "flash" else "")
            print(f"phase cli full: {impl}: launches {counts} over {total} "
                  f"updates{on}; expected {want} (encoder layers kept by "
                  f"layerdrop per update {kept})")
            assert counts == want, (counts, want)
            span = recs[-1]["at"] - recs[CLI_WARM - 1]["at"]
            ups = CLI_TIMED / span
            out[impl] = (counts, ups, peak_gb)
            print(f"phase cli full: {impl}: B {TRAIN_B} x {SECONDS:g} s, U "
                  f"{CLI_WORDS + 1} in a bucket of 64, {CLI_WARM} warm + "
                  f"{CLI_TIMED} timed updates in {span:.4f} s -> {ups:.3f} "
                  f"updates/s ({TRAIN_B * SECONDS * ups:.2f} audio-sec/s), "
                  f"peak memory {peak_gb:.3f} GB, loss "
                  f"{recs[0]['loss_total']:.2f} -> "
                  f"{recs[-1]['loss_total']:.2f}, grad norm "
                  f"{recs[-1]['grad_norm']:.3f}, skipped 0; the whole call "
                  f"(model, {total} updates, checkpoint) {wall:.1f} s "
                  f"[{card}]")
            if impl == "flash":
                # resume: a second call continues from the saved step
                counts2, recs2, _, kept2, _ = _run_cli(
                    argv(impl, total + CLI_RESUMED), n_layers, n_dec)
                assert [r["step"] for r in recs2] == [total + 1, total + 2]
                assert all(math.isfinite(r["loss_total"])
                           and r["skipped"] == 0.0 for r in recs2), recs2
                assert counts2["blockwise_flash_attention_packed"] == sum(
                    kept2) == counts2["blockwise_flash_attention_bwd"]
                saved = sorted(p.name for p in (root / "ckpt_flash").glob(
                    "step_*"))
                assert saved == [f"step_{total + CLI_RESUMED:09d}"], saved
                print(f"phase cli full: flash: a second call resumed at "
                      f"update {total} and took {CLI_RESUMED} more (loss "
                      f"{recs2[-1]['loss_total']:.2f}; K2 == K3 == "
                      f"{sum(kept2)} launches); checkpoints kept: {saved}")
            torch.cuda.empty_cache()
    (fc, fu, fg), (dc, du, dg) = out["flash"], out["dense"]
    print(f"phase cli full: flash {fu:.3f} updates/s, {fg:.3f} GB peak; "
          f"dense {du:.3f} updates/s, {dg:.3f} GB peak, through the same "
          f"entry point in this call [{card}]")
    return fc


# -- serving and the eval CLI ------------------------------------------------

SERVING_TINY = (("s0", 900), ("s1", 700), ("s2", 500), ("s3", 800))
SERVING_TINY_KW = dict(blocks_per_step=1, max_len=24, max_emit_per_chunk=4)


def _tiny_serving_model(dev):
    """The tiny model with unit-norm embedding rows and the blank row at
    0.75 (tests/test_torch_port_serving.py's recipe): streams emit
    different texts from different chunks on."""
    import torch

    w2v, caat, model = _tiny_model()
    with torch.no_grad():
        e = model.decoder.lm.embed_tokens.weight
        e /= e.norm(dim=1, keepdim=True)
        e[caat.bos] *= 0.75
    return w2v, caat, model.to(dev)


def _serve_tiny(sess, wavs):
    """Staggered joins, a stall and recycling on 2 slots: s0 joins with all
    its audio, s1 with its first chunk only and the rest 4 steps later, s2
    and s3 take the slots that free up."""
    assert sess.add_stream("s0")
    sess.push("s0", wavs["s0"], is_end=True)
    assert sess.add_stream("s1")
    sess.push("s1", wavs["s1"][:200])
    waiting = ["s2", "s3"]
    for it in range(200):
        sess.step()
        if it == 3:
            sess.push("s1", wavs["s1"][200:], is_end=True)
        while waiting and sess.add_stream(waiting[0]):
            sess.push(waiting[0], wavs[waiting[0]], is_end=True)
            waiting.pop(0)
        if len(sess._results) == len(wavs):
            break
    return {sid: sess.result(sid) for sid in wavs}


def phase_serving_parity():
    """Tiny model, float32: ServingSession on the card == on the CPU == the
    cached decoder on the card run alone on each stream; staggered joins, a
    stall, recycling, a compaction."""
    import torch
    from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder
    from wav2vec_s_tpu_torch.stream.serving import ServingSession

    rng = np.random.default_rng(7)
    wavs = {sid: rng.standard_normal(n).astype(np.float32) * 0.3
            for sid, n in SERVING_TINY}
    out, compactions = {}, {}
    for d in ("cpu", "cuda"):
        w2v, caat, model = _tiny_serving_model(d)
        vocab = _vocab(caat.vocab_size)
        sess = ServingSession(model, vocab, w2v, n_slots=2, t_cap=96,
                              **SERVING_TINY_KW)
        out[d] = _serve_tiny(sess, wavs)
        compactions[d] = sess.compactions
    dec = CachedFusedGreedyDecoder(model, vocab, w2v, t_cap=128,
                                   **SERVING_TINY_KW)
    solo = {}
    for sid, wav in wavs.items():
        texts, delays = dec.decode_corpus([wav])
        solo[sid] = (texts[0], delays[0])
    words = {sid: len(d) for sid, (_, d) in out["cuda"].items()}
    same_cpu, same_solo = out["cuda"] == out["cpu"], out["cuda"] == solo
    print(f"phase serving parity: tiny float32, 4 streams on 2 slots "
          f"(staggered joins, a stall, recycling; compactions {compactions}):"
          f" cuda == cpu: {same_cpu}, == the cached decoder alone on each "
          f"stream: {same_solo} (words per stream {words})")
    assert same_cpu and same_solo
    assert all(c > 0 for c in compactions.values()), compactions
    texts = [t for t, _ in solo.values()]
    assert sum(map(bool, texts)) >= 2 and len(set(texts)) >= 3, texts
    torch.cuda.empty_cache()


EVAL_STREAMS, EVAL_BATCH, SIMUL_SECONDS = 64, 32, 4.0


def _eval_corpus(root, vocab_size):
    """The eval phase's files under ``root``: 64 seeded-noise 10-s wavs
    (dev.tsv), 2 of 4 s (simul.tsv), a dict of ``vocab_size`` entries."""
    from wav2vec_s_tpu_torch.data.audio import write_wav
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(vocab_size - Dictionary().nspecial)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    for name, n, seconds in (("dev", EVAL_STREAMS, SECONDS),
                             ("simul", 2, SIMUL_SECONDS)):
        lines = ["id\taudio\tn_frames\ttgt_text"]
        S = int(seconds * 16000)
        for i in range(n):
            path = root / f"{name}{i}.wav"
            write_wav(path, rng.standard_normal(S).astype(np.float32) * 0.1)
            text = " ".join(words[j] for j in rng.integers(0, len(words), 20))
            lines.append(f"{name}{i}\t{path}\t{S}\t{text}")
        (root / f"{name}.tsv").write_text("\n".join(lines) + "\n")


def _eval_cli(argv):
    """One call of ``eval.cli.main`` with every launch count set to 0 just
    before it -> (JSON lines it printed, counts, kernel sets, the decoder
    it built and its (batch, texts, delays) per ``decode_corpus``)."""
    import contextlib
    import io
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.eval import cli

    made = []
    real = cli.make_decoder

    def recording(*a, **kw):
        dec = real(*a, **kw)
        decode, calls = dec.decode_corpus, []

        def recorded(wavs):
            out = decode(wavs)
            calls.append((wavs, out))
            return out

        dec.decode_corpus = recorded
        made.append((dec, decode, calls))
        return dec

    stdout = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    with mock.patch.object(cli, "make_decoder", recording), \
            contextlib.redirect_stdout(stdout):
        cli.main(argv)
    torch.cuda.synchronize()
    counts, sets = _counts(), _set_paths()
    lines = [json.loads(ln) for ln in stdout.getvalue().splitlines()
             if ln.startswith("{")]
    return lines, counts, sets, made


def _same_as_direct(made):
    """The CLI's texts and delays == the same decoder's ``decode_corpus``
    called again on the same batches -> number of streams checked."""
    n = 0
    for _, decode, calls in made:
        for wavs, out in calls:
            assert decode(wavs) == out, "CLI decode != direct decode"
            n += len(wavs)
    return n


def phase_eval_cli_full(card):
    """The eval entry point at Base + CAAT base width, bf16, random weights
    from seed 0 saved once through checkpoint/io.py: batch-decode (cached,
    one-shot under flash, stream-beam), sweep, simul (flash) and score ->
    {path: launch counts}."""
    import pathlib
    import tempfile

    import torch
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
    from wav2vec_s_tpu_torch.eval.wer import corpus_wer
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.step import TrainState

    paths = {}
    S = int(SECONDS * 16000)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        w2v, caat, model = _base_model(torch.device("cuda"))
        mgr = CheckpointManager(root / "ckpt", keep_last=1)
        mgr.save(0, TrainState.create(model, build_optimizer(OptimConfig())))
        del model
        torch.cuda.empty_cache()
        _eval_corpus(root, caat.vocab_size)
        print(f"phase eval cli: checkpoint of Base + CAAT base (seed 0) and "
              f"{EVAL_STREAMS} wavs of {SECONDS:g} s + 2 of "
              f"{SIMUL_SECONDS:g} s written in {time.perf_counter() - t:.1f} "
              f"s")
        common = ["--ckpt-dir", str(root / "ckpt"), "--device", "cuda"]
        ov = [f"data.vocab={root}/dict.txt", "model.dtype=bfloat16",
              "caat.dtype=bfloat16"]
        dev_tsv = ["--manifest", str(root / "dev.tsv")]
        frames = (S - 400) // 320 + 1
        n_chunks = {srb: (frames - w2v.right_context)
                    // (w2v.main_context * srb) for srb in (2, 4)}
        L = w2v.encoder_layers

        runs = (
            ("eval_cli_cached", ["batch-decode", *dev_tsv, "--decoder",
                                 "cached", "--batch-size", str(EVAL_BATCH)],
             [], {"K1": L * n_chunks[2] * (EVAL_STREAMS // EVAL_BATCH),
                  "K2": 0}),
            ("eval_cli_oneshot", ["batch-decode", *dev_tsv, "--decoder",
                                  "oneshot"], ["model.attention_impl=flash"],
             {"K1": 0, "K2": L * EVAL_STREAMS // ENCODE_BATCH}),
            ("eval_cli_stream_beam", ["batch-decode", *dev_tsv, "--decoder",
                                      "stream-beam"], [],
             {"K1": L * n_chunks[2], "K2": 0}),
            ("eval_cli_sweep", ["sweep", *dev_tsv, "--decoder", "cached",
                                "--steps", "2,4"], [],
             {"K1": L * (n_chunks[2] + n_chunks[4]), "K2": 0}))
        hyps = None
        for path, argv, extra, want in runs:
            t = time.perf_counter()
            lines, counts, sets, made = _eval_cli(
                [argv[0], *common, *argv[1:], *ov, *extra])
            wall = time.perf_counter() - t
            for ln in lines:
                print(f"phase eval cli: {path}: {json.dumps(ln)} [{card}]")
            _check_launches(path, counts, sets, want)
            n_same = _same_as_direct(made)
            assert len(lines) == (2 if path == "eval_cli_sweep" else 1)
            for ln in lines:
                assert set(ln) == {"BLEU", "AL", "audio_sec_per_sec", "n",
                                   "step_read_blocks"}, ln
                assert ln["n"] == EVAL_STREAMS and np.isfinite(ln["AL"])
            print(f"phase eval cli: {path}: launches {counts}, expected "
                  f"{want}, by kernel set {sets}; texts and delays == the "
                  f"decoder's decode_corpus on the same {n_same} streams; "
                  f"the whole call {wall:.1f} s")
            paths[path] = counts
            if path == "eval_cli_cached":
                hyps = [t_ for _, _, calls in made for _, (texts, _) in calls
                        for t_ in texts]
            torch.cuda.empty_cache()

        # simul: the agent over the host searcher, its prefix encode on K2
        t = time.perf_counter()
        lines, counts, sets, _ = _eval_cli(
            ["simul", *common, "--manifest", str(root / "simul.tsv"),
             "--max-instances", "2", *ov, "model.attention_impl=flash"])
        (scores,) = lines
        print(f"phase eval cli: eval_cli_simul: {json.dumps(scores)} "
              f"[{card}]")
        k2 = counts["blockwise_flash_attention_packed"]
        _check_launches("eval_cli_simul", counts, sets, {"K1": 0, "K2": None},
                        k2_per_call=w2v.encoder_layers)
        assert scores["num_instances"] == 2 and all(
            np.isfinite(scores[k]) for k in ("AL", "AP", "DAL", "BLEU"))
        print(f"phase eval cli: simul: 2 instances of {SIMUL_SECONDS:g} s, "
              f"K2 {k2} launches ({k2 // w2v.encoder_layers} prefix "
              f"encodes), the whole call {time.perf_counter() - t:.1f} s")
        paths["eval_cli_simul"] = counts

        # score: the cached run's texts against the manifest's
        refs = [ln.split("\t")[3] for ln in
                (root / "dev.tsv").read_text().splitlines()[1:]]
        # the batches ran longest first; every clip has one length, so the
        # sort kept the manifest's order
        (root / "hyp.txt").write_text("\n".join(hyps) + "\n")
        (root / "ref.txt").write_text("\n".join(refs) + "\n")
        (got,), _, _, _ = _eval_cli(
            ["score", "-s", str(root / "hyp.txt"), "-r",
             str(root / "ref.txt"), "--metric", "both"])
        want = {"n": EVAL_STREAMS, "BLEU": round(corpus_bleu(hyps, refs), 2),
                "WER": round(corpus_wer(hyps, refs), 4)}
        assert got == want, (got, want)
        print(f"phase eval cli: score == corpus_bleu / corpus_wer of the "
              f"cached run's texts: {got} [{card}]")
    return paths


SERVE_SLOTS, SERVE_T_CAP, SERVE_STREAMS = 16, 1024, 48
SERVE_PUSH = 10240            # 640 ms per stream per step: one ds2 chunk


def phase_serving_full(card):
    """Base + CAAT base, bf16: a ServingSession of 16 slots and t_cap 1024
    serving 48 streams of seeded lengths between 2 and 10 s, admitted as
    slots free up, 640 ms of audio pushed per stream per step (the last
    push: the rest, with the end), a seeded quarter of the streams stalling
    one step in four -> launch counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from wav2vec_s_tpu_torch.ops.decode_attention import decode_attention
    from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder
    from wav2vec_s_tpu_torch.stream.serving import ServingSession

    dev = torch.device("cuda")
    t = time.perf_counter()
    w2v, caat, model = _base_model(dev)
    vocab = _vocab(caat.vocab_size)
    kw = dict(blocks_per_step=2, max_len=256, max_emit_per_chunk=4)
    sess = ServingSession(model, vocab, w2v, n_slots=SERVE_SLOTS,
                          t_cap=SERVE_T_CAP, **kw)
    rng = np.random.default_rng(0)
    lengths = rng.integers(2 * 16000, 10 * 16000 + 1, SERVE_STREAMS)
    wavs = {f"u{i}": (rng.standard_normal(n) * 0.1).astype(np.float32)
            for i, n in enumerate(lengths)}
    stalls = set(rng.choice(sorted(wavs), SERVE_STREAMS // 4, replace=False))
    print(f"phase serving full: model + session ready in "
          f"{time.perf_counter() - t:.1f} s")

    # K7 in the serving step, which no graph replays: its wrapper counts
    # every launch; the device steps that reset a slot run one LM step more
    resets, device_step = [], sess._device_step

    def counted(*args):
        resets.append(bool(args[-1]))
        return device_step(*args)

    sess._device_step = counted

    def run(ids, profile_step=None):
        """Serve ``ids`` to the end -> (step walls, kernels of the profiled
        step)."""
        waiting, sent, walls, kernels = list(ids), {}, [], None
        for it in range(10000):
            while waiting and sess.add_stream(waiting[0]):
                sent[waiting.pop(0)] = 0
            for sid in list(sent):
                n = len(wavs[sid])
                if sent[sid] >= n or (sid in stalls and it % 4 == 3):
                    continue
                # the last push carries the rest (640 ms to 1.28 s) with the
                # end mark: the end must come with the last chunk's audio
                end = (sent[sid] + SERVE_PUSH
                       if n - sent[sid] > 2 * SERVE_PUSH else n)
                sess.push(sid, wavs[sid][sent[sid]:end], is_end=end == n)
                sent[sid] = end
            sent = {s: v for s, v in sent.items()
                    if s not in sess._results}
            if it == profile_step:
                launched = decode_attention.launches
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    sess.step()
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)]
                kernels = len(names)
                # the wrapper's count of the step is the card's
                k7 = sum("decode_attention" in n for n in names)
                assert k7 == decode_attention.launches - launched, (
                    k7, decode_attention.launches - launched)
            else:
                t_ = time.perf_counter()
                sess.step()
                walls.append(time.perf_counter() - t_)
            if not waiting and all(s in sess._results for s in ids):
                return walls, kernels
        raise AssertionError("the session did not finish its streams")

    # warm-up on the first 16 streams, one of its steps under the profiler
    _, kernels = run(sorted(wavs)[:SERVE_SLOTS], profile_step=12)
    assert kernels is not None, "the warm-up ended before its profiled step"
    sess._results.clear()
    steps0, comp0 = sess.steps, sess.compactions
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    resets.clear()
    t = time.perf_counter()
    walls, _ = run(sorted(wavs))
    wall = time.perf_counter() - t
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, compactions = sess.steps - steps0, sess.compactions - comp0
    assert sorted(sess._results) == sorted(wavs)
    assert compactions > 0, "no compaction ran"
    per_iter = caat.jointer_layers + caat.decoder_layers
    k7_want = (steps * sess.max_emit * per_iter
               + sum(resets) * caat.decoder_layers)
    assert len(resets) == steps and counts["decode_attention"] == k7_want, (
        counts["decode_attention"], k7_want, steps, sum(resets))
    window_ms = sess.window / 16.0
    for sid, (text, delays) in sess._results.items():
        assert delays == sorted(delays), sid
        assert all(0 < d <= len(wavs[sid]) / 16.0 + window_ms
                   for d in delays), (sid, delays)
    # the cached decoder on the same streams, grouped by chunk count (a
    # batch of streams with one chunk count decodes each as it would alone)
    dec = CachedFusedGreedyDecoder(model, vocab, w2v, t_cap=512, **kw)
    enc = dec._encoder(1)
    groups = {}
    for sid, wav in wavs.items():
        frames = (len(wav) - enc.rf) // enc.hop + 1
        groups.setdefault(max((frames - enc.rc) // enc.n_main, 1),
                          []).append(sid)
    same = 0
    for ids in groups.values():
        texts, delays = dec.decode_corpus([wavs[s] for s in ids])
        same += sum(sess._results[s] == (t_, d)
                    for s, t_, d in zip(ids, texts, delays))
    words = sum(len(d) for _, d in sess._results.values())
    audio_s = float(lengths.sum()) / 16000.0
    p50, p99 = (float(np.percentile(walls, q)) * 1e3 for q in (50, 99))
    print(f"phase serving full: {SERVE_STREAMS} streams of 2-10 s on "
          f"{SERVE_SLOTS} slots, t_cap {SERVE_T_CAP}, {len(stalls)} of them "
          f"stalling one step in four: {steps} steps, {compactions} "
          f"compactions, launches {counts} (K7 {k7_want} = {steps} steps x "
          f"{sess.max_emit} x {per_iter} + {sum(resets)} resetting steps x "
          f"{caat.decoder_layers}); text and delays == the cached "
          f"decoder's for {same / SERVE_STREAMS:.3f} of the streams; wall "
          f"per step p50 {p50:.2f} ms, p99 {p99:.2f} ms; {audio_s:.1f} "
          f"audio-s in {wall:.2f} s -> {audio_s / wall:.2f} audio-sec/s "
          f"(steps {sum(walls):.2f} s of it); {kernels} device kernels in "
          f"one step of the warm-up (torch.profiler); peak "
          f"memory {peak_gb:.3f} GB; words {words} [{card}]")
    assert words > 0, "the session emitted nothing"
    del sess, dec
    torch.cuda.empty_cache()
    return counts


# -- pre-training ------------------------------------------------------------

PRETRAIN_T = 628     # 627 frames of a 200960-sample crop, padded to 628
PRETRAIN_B = 5       # 1.4M max_tokens over 250000-sample wavs
PRETRAIN_BUCKETS = ((8, 4), (12, 6), (16, 8), (20, 8), (24, 12), (28, 12),
                    (32, 16))


def phase_flash_pretrain():
    """K2, then K3 at dropout 0 and 0.1, against their twins at the
    pre-training call (B 5, T 628, 12 heads of 64, padded keys) under each
    of the 7 context buckets, bfloat16 on the tensor-core kernels and
    float32 on the CUDA-core kernels; then, per bucket, the bfloat16 kernels
    timed at dropout 0.1 beside their bounds and library calls -> {(mc,
    rc): (K2 ms, K2 bound, K2 library ms, K3 ms, K3 bound, K3 library ms)}.
    """
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_bwd, blockwise_flash_attention_bwd_ref,
        blockwise_flash_attention_packed, blockwise_flash_attention_ref)

    B, T, H, D = PRETRAIN_B, PRETRAIN_T, 12, 768
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    seed, offset = 0x0F1E_2D3C_4B5A_6978, 3
    tol_fwd = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    tol_bwd = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    out_rows = {}
    for mc, rc in PRETRAIN_BUCKETS:
        S = block_layout(T, mc, rc).total_len
        pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
        pad[1, T - 10:T] = True
        pad[1, S - 3:] = True
        valid = ~pad
        lay = (pad, H, T, mc, rc)
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn((B, S, D), generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            do = do * valid[:, :, None].to(dtype)
            path, other = (("tensor_core", "cuda_core")
                           if dtype == torch.bfloat16
                           else ("cuda_core", "tensor_core"))
            for rate in (0.0, 0.1):
                _reset_counts()
                out, m, l = blockwise_flash_attention_packed(
                    q, k, v, *lay, rate, True, seed, offset)
                got = blockwise_flash_attention_bwd(
                    q, k, v, out, do, m, l, *lay, rate, seed, offset)
                torch.cuda.synchronize()
                sets = _set_paths()
                assert (sets["K2"], sets["K3"]) == (
                    {path: 1, other: 0}, {path: 1, other: 0}), sets
                want = blockwise_flash_attention_ref(q, k, v, *lay, rate,
                                                     seed, offset)[0]
                err_f = (out[valid].float() - want[valid].float()).abs(
                ).max().item()
                del want
                ref = blockwise_flash_attention_bwd_ref(
                    q, k, v, out, do, m, l, *lay, rate, seed, offset)
                err_b = []
                for i, (a, b) in enumerate(zip(got, ref)):
                    if i == 0:
                        a, b = a[valid], b[valid]
                    assert torch.isfinite(a).all()
                    err_b.append(((a.float() - b.float()).abs().max()
                                  / b.float().abs().max()).item())
                assert err_f <= tol_fwd[dtype], (mc, rc, dtype, rate, err_f)
                assert max(err_b) <= tol_bwd[dtype], (mc, rc, dtype, rate,
                                                      err_b)
                errs.append(f"{str(dtype)[6:]} p={rate}: {err_f:.3g} / "
                            f"{max(err_b):.3g}")
                del got, ref, out, m, l
        print(f"phase flash pretrain: ({mc}, {rc}) S={S}: K2 forward max "
              f"abs err / K3 max |diff| / max |grad| vs twins (tol bf16 "
              f"2e-2 / 1e-2, f32 1e-4 / 1e-5; bf16 on the tensor-core "
              f"kernels, f32 on the CUDA-core kernels): {'; '.join(errs)}")

        # timing: bfloat16, dropout 0.1, mean per call
        q, k, v, do = (torch.randn((B, S, D), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
        pad[:, T - 1] = True                 # the seq-multiple pad frame
        lay = (pad, H, T, mc, rc, 0.1)
        _reset_counts()
        k2 = _cuda_ms(lambda: blockwise_flash_attention_packed(
            q, k, v, *lay, True, seed, offset), 20)
        out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, True,
                                                     seed, offset)
        k3 = _cuda_ms(lambda: blockwise_flash_attention_bwd(
            q, k, v, out, do, m, l, *lay, seed, offset), 20)
        _on_tensor_cores(_set_paths(), {"K2": 22, "K3": 21})
        qh, kh, vh, mask = _sdpa_inputs(q, k, v, pad, H, T, mc, rc)
        lib_fwd = _cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, dropout_p=0.1), 20)
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        doh = do.reshape(B, S, H, D // H).transpose(1, 2)

        def library():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                               dropout_p=0.1)
            torch.autograd.grad(o, leaves, doh)

        lib_bwd = _cuda_ms(library, 20) - lib_fwd
        pairs = _allowed_pairs(T, mc, rc)
        b2 = _bound(2 * 4 * B * S * D + B * S, 4 * B * D * pairs, "bfloat16")
        b3 = _bound(2 * 8 * B * S * D + 2 * 4 * B * H * S + B * S,
                    10 * B * D * pairs, "bfloat16")
        print(f"phase flash pretrain: ({mc}, {rc}) S={S} B={B} bf16 p=0.1 "
              f"per call: K2 {k2:.4f} ms (bound {b2[0]:.5f} by {b2[1]}, "
              f"library {lib_fwd:.4f}); K3 {k3:.4f} ms (bound {b3[0]:.5f} "
              f"by {b3[1]}, library backward alone {lib_bwd:.4f})")
        out_rows[f"{mc},{rc}"] = {
            "S": S, "K2_ms": k2, "K2_bound_ms": b2[0],
            "K2_library_ms": lib_fwd, "K3_ms": k3, "K3_bound_ms": b3[0],
            "K3_library_ms": lib_bwd}
        del q, k, v, do, out, m, l, qh, kh, vh, mask, leaves, doh
    torch.cuda.empty_cache()
    return out_rows


def _tiny_pretrain_model(dev, attention_impl, dropout: bool):
    """The tiny pre-training model (conv hop 20, 2 layers 32 wide, dh 8),
    float32, random weights from seed 0; the recipe's dropouts or none."""
    import dataclasses

    import torch
    from wav2vec_s_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Model
    from wav2vec_s_tpu_torch.models.modules import random_init_

    w2v = Wav2Vec2Config(
        conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
        encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
        encoder_attention_heads=4, final_dim=16, latent_vars=8,
        n_negatives=10, attention_impl=attention_impl)
    if not dropout:
        w2v = dataclasses.replace(
            w2v, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
            encoder_layerdrop=0.0, dropout_input=0.0, dropout_features=0.0)
    model = random_init_(Wav2Vec2Model(w2v, pretraining=True),
                         torch.Generator().manual_seed(0))
    return model.to(dev)


def _tiny_pretrain_batch(seed=0):
    """3 rows of 2400 samples (119 frames), 56 masked positions per row
    from the batcher's masker."""
    import torch
    from wav2vec_s_tpu_torch.utils.masking import (
        compute_span_mask_np, expected_mask_count)

    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((3, 2400)) * 0.3).astype(np.float32)
    M = expected_mask_count(119)
    mask = compute_span_mask_np((3, 119), None, 0.65, 10, rng,
                                exact_count=M)
    pos = np.stack([np.flatnonzero(r)[:M] for r in mask])
    return {"source": torch.from_numpy(src),
            "mask_positions": torch.from_numpy(pos).long()}


def phase_pretrain_parity():
    """Tiny wav2vec-S pre-training, float32, dropout off: two updates on
    the card (kernels) equal the CPU's (twins), dense and flash, every draw
    of both runs from one CPU generator per update; then, with the
    recipe's dropouts on, flash equals dense on the card under one seed."""
    import torch
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_pretrain_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    cfg = OptimConfig(lr=1e-3, lr_scheduler="inverse_sqrt", warmup_updates=2)
    for impl in ("dense", "flash"):
        runs = {}
        for dev in ("cpu", "cuda"):
            model = _tiny_pretrain_model(dev, impl, dropout=False)
            opt = build_optimizer(cfg)
            state = TrainState.create(model, opt)
            step = make_train_step(make_pretrain_loss_fn(model, 8, 4), opt)
            _reset_counts()
            logs = []
            for i in range(2):
                b = {k: v.to(dev) for k, v in _tiny_pretrain_batch(i).items()}
                state, out = step(state, b, torch.Generator().manual_seed(i))
                logs.append({k: float(out[k]) for k in
                             ("loss_total", "grad_norm", "skipped",
                              "correct", "prob_perplexity")})
            runs[dev] = (logs, {k: v.detach().cpu() for k, v in
                                model.state_dict().items()}, _counts())
        (lc, pc, nc), (lg, pg, ng) = runs["cpu"], runs["cuda"]
        err = max((pc[k] - pg[k]).abs().max().item() for k in pc)
        for a, b in zip(lc, lg):
            assert abs(a["loss_total"] - b["loss_total"]) <= 1e-5 * abs(
                a["loss_total"]), (a, b)
            assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * a[
                "grad_norm"], (a, b)
            assert a["skipped"] == b["skipped"] == 0.0
            assert a["correct"] == b["correct"], (a, b)
        assert err <= 1e-2 * cfg.lr, err
        assert all(v == 0 for v in nc.values()), nc
        flash = 2 * 2 if impl == "flash" else 0
        assert ng["blockwise_flash_attention_packed"] == flash, ng
        assert ng["blockwise_flash_attention_bwd"] == flash, ng
        assert ng["hw_dropout"] == ng["chunk_cache_attention"] == 0, ng
        print(f"phase pretrain parity: tiny, {impl} attention, float32, "
              f"dropout off, 2 updates: cuda (kernels) == cpu (twins): loss "
              f"{[x['loss_total'] for x in lg]} vs "
              f"{[x['loss_total'] for x in lc]} (rtol 1e-5), grad norm "
              f"{[x['grad_norm'] for x in lg]} vs "
              f"{[x['grad_norm'] for x in lc]} (rtol 1e-4), correct "
              f"{[x['correct'] for x in lg]}, params max abs diff "
              f"{err:.3g} (tol {1e-2 * cfg.lr:g}); cuda launches {ng}")

    runs = {}
    for impl in ("flash", "dense"):
        model = _tiny_pretrain_model("cuda", impl, dropout=True)
        b = {k: v.cuda() for k, v in _tiny_pretrain_batch().items()}
        _reset_counts()
        loss, _, _ = make_pretrain_loss_fn(model, 12, 6)(
            b, torch.Generator().manual_seed(11), 0)
        loss.backward()
        runs[impl] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()}, _counts())
    (lf, gf, nf), (ld, gd, nd) = runs["flash"], runs["dense"]
    top = max(g.abs().max().item() for g in gd.values() if g is not None)
    err = max((gf[k] - g).abs().max().item() for k, g in gd.items()
              if g is not None)
    assert all((gf[k] is None) == (g is None) for k, g in gd.items())
    kept = nf["blockwise_flash_attention_packed"]
    print(f"phase pretrain parity: tiny, the recipe's dropouts on, one seed: "
          f"flash loss {lf:.6f} vs dense {ld:.6f} (rtol 1e-5), gradients max "
          f"|diff| / max |grad| {err / top:.3g} (tol 1e-4); flash launches "
          f"{nf}, dense launches {nd}")
    assert abs(lf - ld) <= 1e-5 * abs(ld), (lf, ld)
    assert err <= 1e-4 * top, (err, top)
    assert kept == nf["blockwise_flash_attention_bwd"] > 0
    assert nd["blockwise_flash_attention_packed"] == 0
    assert nd["hw_dropout"] - nf["hw_dropout"] == 2 * kept, (nf, nd)


PRETRAIN_WAVS, PRETRAIN_SAMPLES = 20, 250000
PRETRAIN_WARM, PRETRAIN_TIMED = 2, 10
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def _pretrain_corpus(root):
    """20 seeded-noise wavs of 250000 samples and a pre-training manifest
    (root line, ``path\\tnum_samples`` rows) under ``root``."""
    from wav2vec_s_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(1)
    rows = [str(root)]
    for i in range(PRETRAIN_WAVS):
        write_wav(root / f"p{i}.wav", rng.standard_normal(
            PRETRAIN_SAMPLES).astype(np.float32) * 0.1)
        rows.append(f"p{i}.wav\t{PRETRAIN_SAMPLES}")
    (root / "pretrain.tsv").write_text("\n".join(rows) + "\n")
    return root / "pretrain.tsv"


def _run_pretrain_cli(argv, sites=None):
    """One call of the trainer's entry point with every launch count set to
    0 before it -> (counts, progress records with the host time of each,
    dropout contexts of its updates, host ms of their draws, tile-table
    rebuilds, peak GB); each dropout site's (shape, dtype, rate) added to
    ``sites`` when given."""
    import io
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.ops import flash_attention
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import cli, recipes
    from wav2vec_s_tpu_torch.utils.metrics import JsonProgress

    contexts, records = [], []

    class DrawTimed(recording_context(sites, contexts=contexts)):
        """Times the host draws of an update (negatives, Gumbel noise)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.draw_s = 0.0

        def randint(self, *a, **kw):
            t = time.perf_counter()
            out = super().randint(*a, **kw)
            self.draw_s += time.perf_counter() - t
            return out

        def uniform(self, *a, **kw):
            t = time.perf_counter()
            out = super().uniform(*a, **kw)
            self.draw_s += time.perf_counter() - t
            return out

    class Timed(JsonProgress):
        def __init__(self, **kw):
            super().__init__(stream=io.StringIO(), **kw)

        def log(self, stats, step, tag="train"):
            torch.cuda.synchronize()
            records.append(dict(stats, step=step, tag=tag,
                                at=time.perf_counter()))

    # tables built from nothing: the rebuilds are the first draws' builds
    flash_attention.tile_kinds.cache_clear()
    flash_attention._kinds_on.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with mock.patch.object(recipes, "DropoutContext", DrawTimed), \
            mock.patch.object(cli, "JsonProgress", Timed):
        cli.main(argv)
    torch.cuda.synchronize()
    rebuilds = (flash_attention.tile_kinds.cache_info().misses
                + flash_attention._kinds_on.cache_info().misses)
    counts = _counts()
    _on_tensor_cores(_set_paths(), {
        "K2": counts["blockwise_flash_attention_packed"],
        "K3": counts["blockwise_flash_attention_bwd"]})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    draw_ms = [c.draw_s * 1e3 for c in contexts]
    return counts, records, contexts, draw_ms, rebuilds, peak_gb


def phase_pretrain_full(card):
    """wav2vec-S streaming pre-training through the trainer's entry point
    at Base width (configs/pretrain_base.yaml: bf16, sampled contexts, the
    recipe's dropouts and layerdrop) on 20 seeded-noise wavs of 250000
    samples (B 5 in the 200960-sample bucket): 2 warm + 10 timed updates,
    dense then flash; then the chain save -> convert_cli export -> import
    -> CAAT warm start -> one CAAT update.  -> {path: launch counts}."""
    import math
    import pathlib
    import tempfile
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.checkpoint import convert_cli
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.checkpoint.torch_import import (
        load_torch_checkpoint)
    from wav2vec_s_tpu_torch.train import cli

    total = PRETRAIN_WARM + PRETRAIN_TIMED
    n_layers = 12
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        manifest = _pretrain_corpus(root)
        print(f"phase pretrain full: {PRETRAIN_WAVS} wavs of "
              f"{PRETRAIN_SAMPLES} samples and a manifest written in "
              f"{time.perf_counter() - t:.1f} s")

        def argv(impl):
            return ["--config", os.path.join(CONFIGS, "pretrain_base.yaml"),
                    "--device", "cuda", f"run.save_dir={root}/pre_{impl}",
                    f"run.max_update={total}", "run.log_interval=1",
                    "run.save_interval_updates=0", "run.keep_last=1",
                    "run.validate_interval_updates=0",
                    f"data.train_manifest={manifest}",
                    f"model.attention_impl={impl}"]

        for impl in ("dense", "flash"):
            t = time.perf_counter()
            counts, recs, ctxs, draw_ms, rebuilds, peak_gb = (
                _run_pretrain_cli(argv(impl)))
            wall = time.perf_counter() - t
            assert [r["step"] for r in recs] == list(range(1, total + 1))
            assert all(math.isfinite(r["loss_total"]) and math.isfinite(
                r["grad_norm"]) and r["skipped"] == 0.0
                and "oom_skipped" not in r for r in recs), recs
            buckets = [(int(r["main_context"]), int(r["right_context"]))
                       for r in recs]
            assert len(set(buckets)) >= 3, buckets
            # one build per table at a bucket's first draw, none after
            per_bucket = 4 if impl == "flash" else 0
            assert rebuilds == per_bucket * len(set(buckets)), (
                rebuilds, buckets)
            # sites of an update: dropout_input, dropout_features, the
            # encoder input, 3 per kept layer (attention probabilities,
            # after the attention, after the FFN)
            kept = [(c.sites - 3) // 3 for c in ctxs]
            assert all(0 <= k <= n_layers and 3 + 3 * k == c.sites
                       for k, c in zip(kept, ctxs)), [c.sites for c in ctxs]
            flash_calls = sum(kept) if impl == "flash" else 0
            want = {"blockwise_flash_attention_packed": flash_calls,
                    "blockwise_flash_attention_bwd": flash_calls,
                    "hw_dropout": 2 * (sum(c.sites for c in ctxs)
                                       - flash_calls),
                    "chunk_cache_attention": 0,
                    "transducer_forward_walk": 0,
                    "transducer_reverse_walk": 0,
                    "transducer_forward_walk_block": 0,
                    "transducer_reverse_walk_block": 0,
                    "transducer_alphas": 0,
                    "transducer_betas": 0, "transducer_affine_rows": 0,
                    "decode_attention": 0}
            on = (", K2 and K3 all on the tensor-core kernels"
                  if impl == "flash" else "")
            print(f"phase pretrain full: {impl}: launches {counts} over "
                  f"{total} updates{on}; expected {want} (encoder layers "
                  f"kept by layerdrop per update {kept})")
            assert counts == want, (counts, want)
            span = recs[-1]["at"] - recs[PRETRAIN_WARM - 1]["at"]
            ups = PRETRAIN_TIMED / span
            out[impl] = (counts, ups, peak_gb)
            r0 = recs[0]
            print(f"phase pretrain full: {impl}: B {PRETRAIN_B} x 200960 "
                  f"samples (T {PRETRAIN_T}), M {int(r0['count']) // PRETRAIN_B}"
                  f" masked frames per row, {PRETRAIN_WARM} warm + "
                  f"{PRETRAIN_TIMED} timed updates in {span:.4f} s -> "
                  f"{ups:.3f} updates/s ({PRETRAIN_B * 200960 / 16000 * ups:.2f}"
                  f" audio-sec/s), peak memory {peak_gb:.3f} GB; buckets "
                  f"drawn {buckets}; host draws (negatives + Gumbel "
                  f"uniforms) {np.mean(draw_ms):.3f} ms per update (min "
                  f"{min(draw_ms):.3f}, max {max(draw_ms):.3f}); tile-table "
                  f"rebuilds {rebuilds} for {len(set(buckets))} distinct buckets; "
                  f"loss {recs[0]['loss_total']:.2f} -> "
                  f"{recs[-1]['loss_total']:.2f}, accuracy "
                  f"{recs[-1]['correct'] / recs[-1]['count']:.4f}, prob "
                  f"perplexity {recs[-1]['prob_perplexity']:.1f}, temp "
                  f"{recs[-1]['temp']}, skipped 0; the whole call {wall:.1f} "
                  f"s [{card}]")
            torch.cuda.empty_cache()

        # the chain: the flash run's checkpoint -> a fairseq .pt -> the
        # port's import -> a CAAT warm start that takes one update
        t = time.perf_counter()
        saved, _ = CheckpointManager(root / "pre_flash",
                                     keep_last=0).restore()
        assert saved["step"] == total
        convert_cli.main(["--export-from", str(root / "pre_flash"),
                          "--out", str(root / "pre.pt")])
        back = load_torch_checkpoint(root / "pre.pt")["model"]
        assert sorted(back) == sorted(saved["model"])
        assert all(torch.equal(back[k], v) for k, v in saved["model"].items())
        S = int(SECONDS * 16000)
        tsv, vocab = _cli_corpus(root, TRAIN_B, S, 10000, CLI_WORDS)
        snap = {}
        real_create = cli.TrainState.create

        def create(model, optimizer, plan=None, **kw):
            snap.update({k: v.detach().cpu().clone() for k, v in
                         model.encoder.w2v2_model.state_dict().items()})
            return real_create(model, optimizer, plan, **kw)

        caat_argv = ["--device", "cuda", "run.task=caat",
                     f"run.save_dir={root}/caat", "run.max_update=1",
                     "run.log_interval=1", "run.save_interval_updates=0",
                     f"run.w2v2_model_path={root}/pre.pt",
                     f"data.train_manifest={tsv}", f"data.vocab={vocab}",
                     f"data.max_tokens={TRAIN_B * S}",
                     f"data.max_sample_size={S}", "optim.lr=1e-4",
                     "optim.warmup_updates=100", "model.dtype=bfloat16",
                     "model.attention_impl=flash", "caat.dtype=bfloat16",
                     "caat.step_mode=constant"]
        with mock.patch.object(cli.TrainState, "create", create):
            counts, recs, _, _, _ = _run_cli(caat_argv, n_layers, 12)
        heads = ("quantizer.", "project_q.", "final_proj.")
        enc = {k: v for k, v in saved["model"].items()
               if not k.startswith(heads)}
        assert sorted(snap) == sorted(enc)
        assert all(torch.equal(snap[k], v) for k, v in enc.items())
        assert [r["step"] for r in recs] == [1]
        assert math.isfinite(recs[0]["loss_total"])
        assert recs[0]["skipped"] == 0.0
        print(f"phase pretrain full: chain: step {total} checkpoint -> "
              f"convert_cli export ({len(back)} tensors) == the saved state "
              f"dict key for key -> CAAT train.cli with run.w2v2_model_path: "
              f"its encoder before the first update == the pre-trained one "
              f"({len(enc)} tensors, heads dropped); one update, loss "
              f"{recs[0]['loss_total']:.2f}, launches {counts}; "
              f"{time.perf_counter() - t:.1f} s")
    (dc, du, dg), (fc, fu, fg) = out["dense"], out["flash"]
    print(f"phase pretrain full: dense {du:.3f} updates/s, {dg:.3f} GB peak; "
          f"flash {fu:.3f} updates/s, {fg:.3f} GB peak [{card}]")
    return {"pretrain_dense": dc, "pretrain_flash": fc}


# phase 16: data parallelism, ZeRO-1 and FSDP on the card
DDP_WORLD = 2
DDP_LR = 1e-4
# The 2 ranks against one process over the 8 rows, after two updates: the
# loss and the grad norm within the bounds below.  The ranks' kernels see 4
# rows where one process sees 8 and round otherwise (the loss's chunks of
# rows, the GEMMs' reductions), and a gradient that is a small difference
# of large sums (the shared 10000-row embedding) keeps little of its f32
# precision; Adam then divides each gradient by its own size.  So the
# gradients (through Adam's first moments, linear in them: |diff| /
# (rtol |mu| + atol max |mu|)) and the parameters (max and mean |diff|)
# are held to what one process running the same split (rows 0-3, then
# 4-7, each with its rows' masks, gradients summed) shows against the one
# over 8 rows: the ranks may differ from that process by at most twice as
# much, plus the floors below.  Against that process the ranks must agree
# within DDP_SPLIT_TOL (_two_updates_cpu_vs_cuda's bounds, tighter): the
# parallel step itself adds nothing but the order of one sum.
DDP_SPLIT_TOL = {"loss_rtol": 1e-6, "grad_norm_rtol": 1e-5, "mu": 1.0,
                 "param_over_lr": 1e-2}
DDP_TOL = {"float32": {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4,
                       "mu_rtol": 1e-4, "mu_atol": 1e-6},
           "bfloat16": {"loss_rtol": 5e-3, "grad_norm_rtol": 5e-2,
                        "mu_rtol": 5e-2, "mu_atol": 1e-3}}
DDP_FLOOR = {"mu": 1.0, "param_over_lr": 1e-2}


class _SplitRows:
    """The ``shard`` of a parallel plan for one process that runs the 2
    ranks' rows one after the other (``_ddp_updates(split=True)``)."""

    part = 0

    def shard(self, rows):
        from wav2vec_s_tpu_torch.parallel.mesh import Shard

        return Shard(self.part * rows, (self.part + 1) * rows,
                     DDP_WORLD * rows)
DDP_JOBS = {"f32 dp": ("float32", "dp"), "bf16 dp": ("bfloat16", "dp"),
            "bf16 zero": ("bfloat16", "zero")}


def _ddp_updates(dtype, plan=None, rows=slice(None), split=False):
    """Two flash CAAT updates at Base + CAAT base width, every dropout on
    (the recipe's), random weights from seed 0, on the rows ``rows`` of the
    B 8 x 10 s batches (seeds 0 and 1) -> (logs, CPU state dict, Adam's
    first moments in the single-process layout, state).  ``split``: one
    process runs the ranks' row blocks as microbatches, each with the
    update's generator and its rows' masks, and sums their gradients."""
    import torch
    from wav2vec_s_tpu_torch.checkpoint.io import state_to_host
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    w2v = wav2vec_s_base_config(dtype=dtype, attention_impl="flash")
    caat = caat_base_config(dtype=dtype)
    with dev:
        model = W2V2CaatModel(w2v, caat)
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    if plan is not None:
        plan.prepare(model)
    opt = build_optimizer(OptimConfig(
        lr=DDP_LR, clip_norm=2.0, weight_decay=0.01,
        lr_scheduler="inverse_sqrt", warmup_updates=2))
    state = TrainState.create(model, opt, plan)
    split_rows = _SplitRows() if split else None
    loss_fn = make_caat_loss_fn(model, caat, 16, 8,
                                plan=split_rows if split else plan)
    seed = [0]

    def split_loss(mb, generator, step_no):
        generator.manual_seed(seed[0])
        out = loss_fn(mb, generator, step_no)
        split_rows.part += 1
        return out

    step = make_train_step(split_loss if split else loss_fn, opt,
                           accum_steps=DDP_WORLD if split else 1)
    S = int(SECONDS * 16000)
    logs = []
    for i in range(2):
        batch = _train_batch(TRAIN_B, S, TRAIN_U, caat.vocab_size, caat.eos,
                             dev, seed=i)
        batch = {k: v[rows] for k, v in batch.items()}
        if split:
            batch = {k: v.reshape((DDP_WORLD, -1) + v.shape[1:])
                     for k, v in batch.items()}
            split_rows.part, seed[0] = 0, i
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, out = step(state, batch, torch.Generator().manual_seed(i))
        rec = {k: float(out[k]) for k in ("loss_total", "sample_size",
                                          "grad_norm", "skipped")}
        logs.append(dict(rec, update_s=time.perf_counter() - t))
    payload = state_to_host(state)
    params = {k: v.float() for k, v in payload["model"].items()}
    mu = dict(zip((n for n, _ in model.named_parameters()),
                  payload["opt"]["mu"]))
    return logs, params, mu, state


def _ddp_rank(rank, world, store, out):
    """One rank of phase 16a: cuda:0, gloo; each job's two updates on this
    rank's rows, its launches, the plan's all-reduce of one update's
    gradients timed, the moments' bytes."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from wav2vec_s_tpu_torch.parallel.mesh import (
        make_mesh, process_local_rows)
    from wav2vec_s_tpu_torch.parallel.sharding import ParallelPlan

    torch.cuda.set_device(0)
    # float32 references in full precision, as in main()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, device_type="cuda", backend="gloo")
        res = {}
        for name, (dtype, mode) in DDP_JOBS.items():
            plan = ParallelPlan(mesh, mode)
            rows = process_local_rows(TRAIN_B, mesh)
            _reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs, params, mu, state = _ddp_updates(dtype, plan, rows)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = _counts()
            grads = [torch.zeros_like(p) for p in state.model.parameters()]
            count = torch.ones((), device="cuda")
            reduce_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                plan.reduce(grads, count)
                torch.cuda.synchronize()
                reduce_ms.append((time.perf_counter() - t) * 1e3)
            moments = sum(t.numel() * t.element_size()
                          for f in dataclasses.fields(state.opt_state)
                          if f.name != "count"
                          for t in getattr(state.opt_state, f.name))
            every = [torch.zeros(1, dtype=torch.int64, device="cuda")
                     for _ in range(world)]
            dist.all_gather(every, torch.tensor([moments], device="cuda"))
            res[name] = {"logs": logs, "params": params, "mu": mu,
                         "counts": counts,
                         "reduce_ms": reduce_ms, "wall_s": wall,
                         "moment_bytes": [int(b) for b in every],
                         "n_params": sum(p.numel()
                                         for p in state.model.parameters())}
            del state, grads
            torch.cuda.empty_cache()
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_ddp(card):
    """16a: two ranks on cuda:0 over gloo, each with 4 of the 8 rows, the
    port's data-parallel step (summed gradients all-reduced, divided by the
    global count), flash attention and every dropout on, against one
    process over the 8 rows: float32 (they differ only in the order of the
    gradient sums), then bfloat16, then bfloat16 under ZeRO-1.  ->
    {job: launch counts of rank 0}."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    one, split = {}, {}
    for dtype in ("float32", "bfloat16"):
        for into, kw in ((one, {}), (split, {"split": True})):
            t = time.perf_counter()
            logs, params, mu, state = _ddp_updates(dtype, **kw)
            torch.cuda.synchronize()
            into[dtype] = {"logs": logs, "params": params, "mu": mu,
                           "wall_s": time.perf_counter() - t}
            del state
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.pt")
        ctx = mp.start_processes(
            _ddp_rank, args=(DDP_WORLD, os.path.join(tmp, "store"), out),
            nprocs=DDP_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + 900
        try:
            while not ctx.join(timeout=30):
                if time.monotonic() > deadline:
                    raise TimeoutError("phase 16a: the ranks did not finish")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        ranks = torch.load(out, weights_only=False)
    counts = {}
    for name, (dtype, mode) in DDP_JOBS.items():
        r = ranks[name]
        c = r["counts"]
        tol = DDP_TOL[dtype]
        d = _run_diff(r, one[dtype], tol)
        ds = _run_diff(split[dtype], one[dtype], tol)
        dr = _run_diff(r, split[dtype], tol)
        print(f"phase ddp: {name}, 2 ranks on one card over gloo (B 4 + 4 "
              f"x {SECONDS:g} s, flash, the recipe's dropouts): loss "
              f"{[x['loss_total'] for x in r['logs']]}, grad norm "
              f"{[x['grad_norm'] for x in r['logs']]}; against one process "
              f"over the 8 rows {_diff_text(d)}; one process running the "
              f"same split against the one over 8 rows {_diff_text(ds)}; "
              f"the ranks against the split {_diff_text(dr)} (lr "
              f"{DDP_LR:g}, tolerances {tol}, floors {DDP_FLOOR}); sample "
              f"size {[x['sample_size'] for x in r['logs']]}; rank 0 "
              f"launches K2 {c['blockwise_flash_attention_packed']} K3 "
              f"{c['blockwise_flash_attention_bwd']} K4 {c['hw_dropout']} "
              f"walks {c['transducer_forward_walk']} / "
              f"{c['transducer_reverse_walk']}; two updates {r['wall_s']:.2f}"
              f" s (one process {one[dtype]['wall_s']:.2f} s, model build "
              f"included); the plan's all-reduce of one update's "
              f"{r['n_params']} float32 gradients "
              f"{min(r['reduce_ms']):.1f} ms (best of "
              f"{['%.1f' % x for x in r['reduce_ms']]}); optimizer moments "
              f"per rank {r['moment_bytes']} bytes [{card}]")
        logs = one[dtype]["logs"]
        assert all(x["skipped"] == 0.0 for x in r["logs"] + logs)
        assert all(a["sample_size"] == b["sample_size"]
                   for a, b in zip(r["logs"], logs))
        assert c["blockwise_flash_attention_packed"] > 0 and c[
            "blockwise_flash_attention_bwd"] > 0 and c["hw_dropout"] > 0
        assert c["transducer_forward_walk"] > 0 and c[
            "transducer_reverse_walk"] > 0
        assert dr["loss"] <= DDP_SPLIT_TOL["loss_rtol"], dr
        assert dr["gnorm"] <= DDP_SPLIT_TOL["grad_norm_rtol"], dr
        assert dr["mu"] <= DDP_SPLIT_TOL["mu"], dr
        assert dr["pmax"] <= DDP_SPLIT_TOL["param_over_lr"] * DDP_LR, dr
        assert d["loss"] <= tol["loss_rtol"], d
        assert d["gnorm"] <= tol["grad_norm_rtol"], d
        assert d["mu"] <= 2 * ds["mu"] + DDP_FLOOR["mu"], (d, ds)
        floor = DDP_FLOOR["param_over_lr"] * DDP_LR
        assert d["pmax"] <= 2 * ds["pmax"] + floor, (d, ds)
        assert d["pmean"] <= 2 * ds["pmean"] + floor, (d, ds)
        if mode == "zero":
            whole = ranks["bf16 dp"]["moment_bytes"][0]
            assert all(0.45 * whole <= b <= 0.55 * whole
                       for b in r["moment_bytes"]), (r["moment_bytes"],
                                                      whole)
        counts[name] = c
    return counts, one, split


def _diff_text(d):
    return (f"(loss max rel diff {d['loss']:.3g}, grad norm {d['gnorm']:.3g}"
            f", Adam's first moments {d['mu']:.3g} of the tolerance in "
            f"{d['mu_worst']}, params max |diff| {d['pmax']:.3g} mean "
            f"{d['pmean']:.3g}, largest in {d['worst']})")


def _run_diff(run, ref, tol):
    """{loss, gnorm: max relative difference over the updates; mu: the
    largest |diff| of Adam's first moments over rtol |mu| + atol max |mu|
    (mu_worst: that parameter); pmax, pmean: max and mean |diff| of the
    parameters; worst: the 3 parameters of the largest} of a run against
    a reference run."""
    import torch

    per = {k: (run["params"][k] - v).abs() for k, v in ref["params"].items()}
    diffs = torch.cat([t.flatten() for t in per.values()])
    scale = max(m.abs().max().item() for m in ref["mu"].values())
    ratios = {k: ((run["mu"][k].float() - b.float()).abs()
                  / (tol["mu_rtol"] * b.float().abs()
                     + tol["mu_atol"] * scale)).max().item()
              for k, b in ref["mu"].items()}
    worst_mu = max(ratios, key=ratios.get)
    return {"loss": max(abs(a["loss_total"] - b["loss_total"])
                        / abs(b["loss_total"])
                        for a, b in zip(run["logs"], ref["logs"])),
            "gnorm": max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                         for a, b in zip(run["logs"], ref["logs"])),
            "mu": ratios[worst_mu], "mu_worst": worst_mu,
            "pmax": diffs.max().item(), "pmean": diffs.mean().item(),
            "worst": sorted(per, key=lambda k: -per[k].max().item())[:3]}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _cli_parallel_rank(spec) -> int:
    """16b's rank, launched by torch.distributed.run: the trainer's entry
    point once per run of ``spec`` (a json list of [argv, stdout file]) in
    this one process, each run's output into its file.  No group is
    started here: every ``cli.main`` starts the default group from the
    launcher's environment (``parallel.mesh.init_from_env``: the rank's
    device, nccl, ``env://``) and destroys it when it ends, as a user's
    torchrun launch of the trainer does, so each of the three runs covers
    that path."""
    import contextlib
    import json

    import torch.distributed as dist
    from wav2vec_s_tpu_torch.train import cli

    with open(spec) as f:
        runs = json.load(f)
    for argv, out in runs:
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            cli.main(argv)
        assert not dist.is_initialized(), "the trainer left its group up"
    return 0


def phase_cli_parallel(card):
    """16b: the training entry point under torch.distributed.run with one
    rank (nccl), one launch that runs data parallelism, then run.zero=true,
    then run.fsdp=true (``_cli_parallel_rank``; each run starts and ends
    the process group itself), each against the same call
    without a process group (in this process), on
    configs/pretrain_base.yaml at phase 15's shapes (B 5 x 200960 samples,
    flash, the recipe's dropouts, sampled contexts), 3 updates: the same
    updates and skips, the losses within rtol 1e-5 and the grad norms
    within 1e-4, the final parameters within 1e-2 x lr."""
    import contextlib
    import io
    import json
    import pathlib
    import tempfile

    import torch
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.train import cli
    from wav2vec_s_tpu_torch.train.config import load_config

    torch.cuda.empty_cache()
    config = os.path.join(CONFIGS, "pretrain_base.yaml")
    lr = load_config(config, []).optim.lr
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

    def records(text):
        return [json.loads(x) for x in text.splitlines()
                if x.startswith("{")]

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        manifest = _pretrain_corpus(root)
        argvs = {}
        for name, extra in (("no group", []), ("dp", []),
                            ("zero", ["run.zero=true"]),
                            ("fsdp", ["run.fsdp=true"])):
            tag = name.replace(" ", "_")
            argvs[name] = ["--config", config, "--device", "cuda",
                           f"run.save_dir={root}/{tag}", "run.max_update=3",
                           "run.log_interval=1", "run.save_interval_updates=0",
                           "run.keep_last=1",
                           "run.validate_interval_updates=0",
                           f"data.train_manifest={manifest}",
                           "model.attention_impl=flash", *extra]
        t = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argvs["no group"])
        runs = {"no group": (records(out.getvalue()), CheckpointManager(
            root / "no_group", keep_last=0).restore()[0])}
        no_group_s = time.perf_counter() - t
        torch.cuda.empty_cache()
        spec = root / "ranks.json"
        group = ("dp", "zero", "fsdp")
        spec.write_text(json.dumps([[argvs[name], str(root / f"{name}.out")]
                                    for name in group]))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes",
               "1", "--nproc-per-node", "1", "--master-addr", "localhost",
               "--master-port", str(_free_port()), os.path.abspath(__file__),
               "--cli-parallel-rank", str(spec)]
        t = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, env=env, cwd=repo)
        launch_s = time.perf_counter() - t
        if done.returncode:
            raise RuntimeError(f"phase cli parallel: the launch failed:\n"
                               f"{done.stdout[-3000:]}\n"
                               f"{done.stderr[-3000:]}")
        for name in group:
            runs[name] = (records((root / f"{name}.out").read_text()),
                          CheckpointManager(root / name,
                                            keep_last=0).restore()[0])
    want, ref = runs["no group"]
    assert [r["step"] for r in want] == [1, 2, 3], want
    for name in group:
        recs, payload = runs[name]
        assert [r["step"] for r in recs] == [1, 2, 3], recs
        assert [r["skipped"] for r in recs] == [r["skipped"] for r in want]
        loss = max(abs(a["loss_total"] - b["loss_total"]) / abs(b["loss_total"])
                   for a, b in zip(recs, want))
        gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                    for a, b in zip(recs, want))
        pmax = max((payload["model"][k].float() - v.float()).abs().max()
                   .item() for k, v in ref["model"].items())
        print(f"phase cli parallel: torch.distributed.run, 1 rank, nccl, "
              f"{name} vs no process group, pretrain_base.yaml (B "
              f"{PRETRAIN_B} x 200960, flash), 3 updates: loss "
              f"{[r['loss_total'] for r in recs]} (max rel diff {loss:.3g}),"
              f" grad norm max rel diff {gnorm:.3g}, params max |diff| "
              f"{pmax:.3g} (lr {lr:g}), the same "
              f"{int(sum(r['skipped'] for r in recs))} skips [{card}]")
        assert loss <= 1e-5 and gnorm <= 1e-4, (name, loss, gnorm)
        assert pmax <= 1e-2 * lr, (name, pmax)
        assert payload["step"] == ref["step"] == 3
    print(f"phase cli parallel: the launch of dp, zero and fsdp in one "
          f"rank {launch_s:.1f} s; the call without a group, in this "
          f"process, {no_group_s:.1f} s [{card}]")


# -- phase 17: the offline-ASR family ----------------------------------------

ASR_WARM, ASR_TIMED = 2, 10
ASR_CLIPS = 16             # training wavs of 10 s: two batches of 8
ASR_VALID = 8              # validation wavs of 10 s: one batch
LARGE_B = 4
LARGE_MICRO_B = LARGE_B // 2   # offline_asr_large.yaml: update_freq 2
CTC_DECODE_WAVS = 64
GENERATE_WAVS = 8
def phase_asr_parity():
    """17a (``tools/asr_parity.py``): the tiny CTC (with and without a row
    no path fits) and seq2seq recipes, dense and flash: loss and every
    gradient on the card against the CPU; the three greedy decoders and the
    beam generator: the same ids."""
    from wav2vec_s_tpu_torch.tools import asr_parity as ap

    rtol, atol = ap.GRAD_TOL
    for kind, infeasible in (("ctc", False), ("ctc", True), ("s2s", False)):
        for impl in ("dense", "flash"):
            cpu, card = (ap.loss_and_grads(kind, impl, infeasible, dev)
                         for dev in ("cpu", "cuda"))
            rel, worst = ap.gap(cpu, card)
            label = kind + (" (a row no path fits)" if infeasible else "")
            print(f"phase asr parity: tiny {label}, {impl}, float32: loss "
                  f"cpu {cpu[0]:.6f} cuda {card[0]:.6f} (rel diff "
                  f"{rel:.3g}, tol {ap.LOSS_RTOL:g}); every gradient within "
                  f"{worst:.3g} of the bound |diff| <= {rtol:g} |g| + "
                  f"{atol:g} max |g|")
            assert rel <= ap.LOSS_RTOL and worst <= 1.0, (label, impl, rel,
                                                          worst)
            if infeasible:
                assert ap.FLOOR[0] < cpu[0] < ap.FLOOR[1], cpu[0]

    for kind in ("ctc", "s2s", "transducer"):
        cpu, card = (ap.greedy(kind, dev) for dev in ("cpu", "cuda"))
        for x, y in zip(cpu, card):
            np.testing.assert_array_equal(x, y)
        print(f"phase asr parity: tiny {kind} greedy decode (flash encode) "
              f"cuda == cpu: lens {card[1].tolist()}")
    cpu, card = (ap.beam(dev) for dev in ("cpu", "cuda"))
    assert [h.tokens for h in card] == [h.tokens for h in cpu]
    np.testing.assert_allclose([h.score for h in card],
                               [h.score for h in cpu], rtol=1e-5)
    print(f"phase asr parity: tiny Seq2SeqBeamGenerator (beam 4) cuda == "
          f"cpu: {len(card)} hypotheses, token ids equal, scores within "
          f"rtol 1e-5")


def _asr_corpus(root, name, n, seconds, seed):
    """``n`` seeded-noise wavs of ``seconds`` under ``root`` and two S2T
    tsvs over them -> (letters tsv, words tsv): the transcript
    (``src_text``, what ``task_type: asr`` trains on) is 20 random words
    spelled in letters (CTC, char tokenizer) or taken from the word dict
    (seq2seq); ``tgt_text`` is the word one in both."""
    from wav2vec_s_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    S = int(seconds * 16000)
    rows = {"letters": [], "words": []}
    for i in range(n):
        path = root / f"{name}{i}.wav"
        write_wav(path, rng.standard_normal(S).astype(np.float32) * 0.1)
        words = " ".join(f"w{j}" for j in rng.integers(0, 9990, 20))
        spelled = " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, k))
                           for k in rng.integers(2, 7, 20))
        for kind, src in (("letters", spelled), ("words", words)):
            rows[kind].append(f"{name}{i}\t{path}\t{S}\t{words}\t{src}")
    out = []
    for kind, lines in rows.items():
        tsv = root / f"{name}_{kind}.tsv"
        tsv.write_text("\n".join(["id\taudio\tn_frames\ttgt_text\tsrc_text",
                                  *lines]) + "\n")
        out.append(tsv)
    return tuple(out)


def _asr_dicts(root):
    """A letter dict (``▁`` and a-z: the char tokenizer's pieces) and a
    10000-entry word dict."""
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    letters = ["▁"] + [chr(97 + i) for i in range(26)]
    (root / "letters.txt").write_text("".join(f"{c} 1\n" for c in letters))
    (root / "words.txt").write_text("".join(
        f"w{i} 1\n" for i in range(10000 - Dictionary().nspecial)))


def _run_asr_cli(argv, sites):
    """One call of the trainer's entry point with every launch count set to
    0 before it -> (counts, kernel sets, progress records with the host
    time of each, encoder layers kept per training forward, peak GB); each
    dropout site's (shape, dtype, rate) added to ``sites``."""
    import io
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import cli, recipes
    from wav2vec_s_tpu_torch.utils.metrics import JsonProgress

    kept, records = [], []

    class Timed(JsonProgress):
        def __init__(self, **kw):
            super().__init__(stream=io.StringIO(), **kw)

        def log(self, stats, step, tag="train"):
            torch.cuda.synchronize()
            records.append(dict(stats, step=step, tag=tag,
                                at=time.perf_counter()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with mock.patch.object(recipes, "DropoutContext",
                           recording_context(sites, kept)), \
            mock.patch.object(cli, "JsonProgress", Timed):
        cli.main(argv)
    torch.cuda.synchronize()
    return (_counts(), _set_paths(), records, kept,
            torch.cuda.max_memory_allocated() / 1e9)


def phase_asr_full(card):
    """17b-d: the offline-ASR family at full width through the entry points
    a user calls; then K4 against its twin at every dropout site's shape
    and rate of 17b-c -> ({path: launch counts}, K4's max abs error)."""
    import pathlib
    import tempfile

    import torch

    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        _asr_dicts(root)
        train = _asr_corpus(root, "train", ASR_CLIPS, SECONDS, 1)
        valid = _asr_corpus(root, "valid", ASR_VALID, SECONDS, 2)
        print(f"phase asr full: {ASR_CLIPS} + {ASR_VALID} wavs of "
              f"{SECONDS:g} s, tsvs and dicts written in "
              f"{time.perf_counter() - t:.1f} s")
        sites = set()
        paths.update(_asr_train_calls(root, train, valid, card, sites))
        paths.update(_asr_large_call(root, train, card, sites))
        paths.update(_asr_eval_calls(root, card))
    return paths, _hold_sites(sites, "asr")


def _hold_sites(sites, label):
    """K4 == its twin at each (shape, dtype, rate[, index map]) that a
    phase's training calls dropped (``recording_context``) -> the max abs
    error."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for shape, dtype, p, *index in sorted(sites, key=str):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        err, _ = _hold_dropout(x, p, DROPOUT_SEED, 17, *index)
        worst = max(worst, err)
        del x
    split = sorted((s[0], s[3]) for s in sites
                   if len(s) > 3 and s[3] is not None)
    print(f"phase {label} dropout: K4 at the {len(sites)} (shape, dtype, "
          f"rate) sites of the phase's training calls"
          + (f" ({len(split)} of them a shard placed by its index map: "
             f"rows, heads or hidden columns; {split[:6]} ...)"
             if split else "")
          + f": outputs and masks bit-equal to the twin, fwd == bwd mask: "
          f"{sorted({(s[0], str(s[1])[6:], s[2]) for s in sites})}")
    torch.cuda.empty_cache()
    return worst


def _asr_train_calls(root, train, valid, card, sites):
    """17b: configs/ctc_asr_base.yaml and configs/offline_asr_base.yaml
    through train.cli, dense then flash, each validating once."""
    import math

    import torch

    S = int(SECONDS * 16000)
    L = 12
    paths = {}
    total = ASR_WARM + ASR_TIMED
    common = [f"data.max_tokens={8 * S}",
              f"data.max_sample_size={S}", "run.log_interval=1",
              "run.save_interval_updates=0", "run.keep_last=1",
              "run.w2v2_model_path=", f"run.max_update={total}"]
    tasks = {
        "ctc": ("ctc_asr_base.yaml", "valid_wer",
                [f"data.vocab={root}/letters.txt",
                 f"data.train_manifest={train[0]}",
                 f"data.valid_manifest={valid[0]}",
                 f"run.validate_interval_updates={total}"]),
        "s2s": ("offline_asr_base.yaml", "valid_bleu",
                [f"data.vocab={root}/words.txt", "data.tokenizer=word",
                 "run.eval_bleu=true", f"data.train_manifest={train[1]}",
                 f"data.valid_manifest={valid[1]}",
                 f"run.validate_interval_updates={total}"]),
    }
    for task, (yaml, key, extra) in tasks.items():
        for impl in ("dense", "flash"):
            path = f"asr_{task}_{impl}"
            argv = ["--config", os.path.join(CONFIGS, yaml), "--device",
                    "cuda", *common, *extra,
                    f"run.save_dir={root}/{path}",
                    f"model.attention_impl={impl}"]
            t = time.perf_counter()
            counts, sets, recs, kept, peak = _run_asr_cli(argv, sites)
            wall = time.perf_counter() - t
            train_recs = [r for r in recs if r["tag"] == "train"]
            (vrec,) = [r for r in recs if r["tag"] == "valid"]
            assert [r["step"] for r in train_recs] == list(
                range(1, total + 1))
            assert all(math.isfinite(r["loss_total"]) and math.isfinite(
                r["grad_norm"]) and r["skipped"] == 0.0
                for r in train_recs), train_recs
            assert math.isfinite(vrec["valid_loss"]) and math.isfinite(
                vrec[key]), vrec
            # validation: the loss forward and the decode's encode, one
            # batch, every layer (eval mode: no layerdrop)
            flash = impl == "flash"
            want_k3 = sum(kept) if flash else 0
            want_k2 = want_k3 + (2 * L if flash else 0)
            assert counts["blockwise_flash_attention_bwd"] == want_k3, (
                path, counts, kept)
            assert counts["blockwise_flash_attention_packed"] == \
                want_k2, (path, counts, kept)
            assert counts["hw_dropout"] > 0 and counts[
                "chunk_cache_attention"] == 0, (path, counts)
            _on_tensor_cores(sets, {"K1": 0, "K2": want_k2,
                                    "K3": want_k3})
            span = train_recs[-1]["at"] - train_recs[ASR_WARM - 1]["at"]
            ups = ASR_TIMED / span
            paths[path] = counts
            vstats = {k: v for k, v in vrec.items()
                      if k.startswith("valid")}
            print(f"phase asr full: {path}: configs/{yaml}, Base, bf16, "
                  f"B 8 x {SECONDS:g} s, the recipe's dropouts: "
                  f"launches {counts}; encoder layers kept per forward "
                  f"{kept}; {ASR_WARM} warm + {ASR_TIMED} timed updates "
                  f"in {span:.4f} s -> {ups:.3f} updates/s "
                  f"({8 * SECONDS * ups:.2f} audio-sec/s), peak memory "
                  f"{peak:.3f} GB, loss {train_recs[0]['loss_total']:.2f}"
                  f" -> {train_recs[-1]['loss_total']:.2f}, validation "
                  f"{vstats}; the whole call {wall:.1f} s [{card}]")
            torch.cuda.empty_cache()
    return paths


def _asr_large_call(root, train, card, sites):
    """17c: configs/offline_asr_large.yaml, one call: 2 updates of B 4,
    flash, no validation."""
    import math

    import torch

    S = int(SECONDS * 16000)
    argv = ["--config", os.path.join(CONFIGS, "offline_asr_large.yaml"),
            "--device", "cuda", f"data.train_manifest={train[1]}",
            f"data.max_tokens={LARGE_B * S}", f"data.max_sample_size={S}",
            "run.log_interval=1", "run.save_interval_updates=0",
            "run.keep_last=1", "run.w2v2_model_path=", "run.max_update=2",
            f"data.vocab={root}/words.txt", "data.tokenizer=word",
            f"run.save_dir={root}/large", "model.attention_impl=flash"]
    t = time.perf_counter()
    counts, sets, recs, kept, peak = _run_asr_cli(argv, sites)
    wall = time.perf_counter() - t
    assert [r["step"] for r in recs] == [1, 2] and all(
        math.isfinite(r["loss_total"]) and r["skipped"] == 0.0
        for r in recs), recs
    assert counts["blockwise_flash_attention_bwd"] == sum(kept) == \
        counts["blockwise_flash_attention_packed"] > 0, (counts, kept)
    _on_tensor_cores(sets, {"K1": 0, "K2": sum(kept), "K3": sum(kept)})
    print(f"phase asr full: asr_s2s_large: configs/offline_asr_large.yaml"
          f" (24 x 1024 encoder, 12 x 1024 decoder, layer_norm_first, "
          f"conv_bias, normalize), bf16, flash, B {LARGE_B} x "
          f"{SECONDS:g} s in 2 microbatches: launches {counts}; losses "
          f"{[round(r['loss_total'], 2) for r in recs]}, peak memory "
          f"{peak:.3f} GB; the whole call (model, 2 updates, "
          f"checkpoint) {wall:.1f} s [{card}]")
    torch.cuda.empty_cache()
    return {"asr_s2s_large": counts}


def _asr_eval_calls(root, card):
    """17d: the eval CLI, each call cold: ctc-decode on 17b's flash CTC
    checkpoint, generate on phase 13's CAAT checkpoint (Base + CAAT base,
    seed 0, written again)."""
    import torch
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.step import TrainState

    L = 12
    paths = {}
    letters_tsv, words_tsv = _asr_corpus(root, "dev", CTC_DECODE_WAVS,
                                         SECONDS, 3)
    model = _base_model(torch.device("cuda"))[2]
    CheckpointManager(root / "caat", keep_last=1).save(
        0, TrainState.create(model, build_optimizer(OptimConfig())))
    del model
    torch.cuda.empty_cache()
    gen_tsv = root / "gen.tsv"
    gen_tsv.write_text("\n".join(
        words_tsv.read_text().splitlines()[:GENERATE_WAVS + 1]) + "\n")
    evals = (
        ("ctc_decode", ["ctc-decode", "--config",
                        os.path.join(CONFIGS, "ctc_asr_base.yaml"),
                        "--ckpt-dir", f"{root}/asr_ctc_flash",
                        "--manifest", str(letters_tsv),
                        f"data.vocab={root}/letters.txt"],
         CTC_DECODE_WAVS, "WER"),
        ("generate", ["generate", "--ckpt-dir", f"{root}/caat",
                      "--manifest", str(gen_tsv), "--metric", "bleu",
                      f"data.vocab={root}/words.txt",
                      "model.dtype=bfloat16", "caat.dtype=bfloat16"],
         GENERATE_WAVS, "BLEU"))
    for path, argv, n, key in evals:
        t = time.perf_counter()
        lines, counts, sets, _ = _eval_cli(
            [argv[0], "--device", "cuda", *argv[1:],
             "model.attention_impl=flash"])
        wall = time.perf_counter() - t
        assert len(lines) == n + 1 and lines[-1]["n"] == n
        assert np.isfinite(lines[-1][key]), lines[-1]
        k2 = counts["blockwise_flash_attention_packed"]
        assert k2 > 0 and k2 % L == 0 and counts[
            "blockwise_flash_attention_bwd"] == 0, (path, counts)
        assert counts["chunk_cache_attention"] == 0 and counts[
            "hw_dropout"] == 0, (path, counts)
        _on_tensor_cores(sets, {"K1": 0, "K2": k2, "K3": 0})
        paths[path] = counts
        print(f"phase asr full: {path}: {n} wavs of {SECONDS:g} s, "
              f"Base, bf16, flash encode: {lines[-1]}; some hypotheses "
              f"{[ln['hypo'][:40] for ln in lines[:2]]}; launches "
              f"{counts} ({k2 // L} encodes); the whole call "
              f"{wall:.1f} s -> {n * SECONDS / wall:.2f} audio-sec/s "
              f"[{card}]")
        torch.cuda.empty_cache()
    return paths


# -- phase 18: the fbank and text CAAT families -----------------------------
FAMILY_CLIPS = 16          # fbank training wavs of 10 s: two batches of 8
FAMILY_VALID = 8           # fbank validation wavs of 10 s: one batch
FAMILY_PAIRS = 64          # text pairs: four batches of 16
FAMILY_SRC = (57, 61)      # source words per pair (+ eos: 58-61 tokens)
FAMILY_TGT = (20, 61)      # target words per pair
FAMILY_SIMUL = 2           # simul streams of 4 s on 18b's checkpoint
#: 18b's one-update calls at full width: (frontend, jointer)
FAMILY_VARIANTS = (("vgg2d", "mha"), ("resnet", "mha"),
                   ("resnet_small", "mha"), ("shallow2d", "concat"),
                   ("shallow2d", "attention"))


def phase_family_parity():
    """18a (``tools/family_parity.py``): every fbank front-end x jointer
    and the text model at tiny widths, float32, the recipe's dropouts on:
    loss and every gradient on the card against the CPU; the fbank agent's
    texts and delays on the card equal the CPU's."""
    from wav2vec_s_tpu_torch.tools import family_parity as fp

    rtol, atol = fp.GRAD_TOL
    for case in fp.CASES:
        cpu, card = (fp.loss_and_grads(*case, dev) for dev in ("cpu",
                                                               "cuda"))
        rel, worst = fp.gap(cpu, card)
        print(f"phase family parity: tiny {'/'.join(filter(None, case))}, "
              f"float32, dropouts on: loss cpu {cpu[0]:.6f} cuda "
              f"{card[0]:.6f} (rel diff {rel:.3g}, tol {fp.LOSS_RTOL:g}); "
              f"{len(card[1])} gradients within {worst:.3g} of the bound "
              f"|diff| <= {rtol:g} |g| + {atol:g} max |g|")
        assert rel <= fp.LOSS_RTOL and worst <= 1.0, (case, rel, worst)
    cpu, card = fp.agent("cpu"), fp.agent("cuda")
    assert card == cpu and any(text for text, _ in card), (cpu, card)
    print(f"phase family parity: tiny fbank agent (SimulEvaluator, beam 2) "
          f"cuda == cpu, texts and delays: "
          f"{[(text[:24], delays[:3]) for text, delays in card]}")


def _family_corpus(root):
    """18b-c's files: ``FAMILY_CLIPS`` + ``FAMILY_VALID`` seeded-noise wavs
    of 10 s (S2T tsvs, 20-word transcripts), 2 of 4 s for simul, the
    10000-entry word dict, ``FAMILY_PAIRS`` seeded sentence pairs."""
    from wav2vec_s_tpu_torch.data.audio import write_wav

    _asr_dicts(root)
    train = _asr_corpus(root, "fbank", FAMILY_CLIPS, SECONDS, 4)[1]
    valid = _asr_corpus(root, "fbankvalid", FAMILY_VALID, SECONDS, 5)[1]
    rng = np.random.default_rng(6)
    S = int(4.0 * 16000)
    lines = ["id\taudio\tn_frames\ttgt_text"]
    for i in range(FAMILY_SIMUL):
        write_wav(root / f"simul{i}.wav",
                  rng.standard_normal(S).astype(np.float32) * 0.1)
        lines.append(f"simul{i}\t{root}/simul{i}.wav\t{S}\t"
                     + " ".join(f"w{j}" for j in rng.integers(0, 9990, 10)))
    (root / "simul.tsv").write_text("\n".join(lines) + "\n")
    pairs = ["id\tsrc_text\ttgt_text"]
    for i in range(FAMILY_PAIRS):
        src, tgt = (" ".join(f"w{j}" for j in rng.integers(
            0, 9990, rng.integers(*span))) for span in (FAMILY_SRC,
                                                        FAMILY_TGT))
        pairs.append(f"p{i}\t{src}\t{tgt}")
    (root / "bitext.tsv").write_text("\n".join(pairs) + "\n")
    return train, valid, root / "bitext.tsv"


def _family_call(argv, sites, lattices, updates):
    """One trainer call (``_run_asr_cli``) of ``updates`` updates ->
    (counts, records, peak GB, updates/s over the timed ones or None,
    wall s); each lattice [B, G, U] that a fused walk of the loss took
    added to ``lattices`` ({shape: the walks that took it})."""
    import math
    import types
    from unittest import mock

    from wav2vec_s_tpu_torch.ops.transducer import analytic, kernels

    def recorded(walk, name):
        def call(lp_blank, *args):
            lattices.setdefault(tuple(lp_blank.shape), set()).add(name)
            return walk(lp_blank, *args)
        return call

    walks = types.SimpleNamespace(
        alphas_and_expected_delay=recorded(
            kernels.alphas_and_expected_delay, "forward"),
        betas_and_expected_delay_bwd=recorded(
            kernels.betas_and_expected_delay_bwd, "reverse"))
    t = time.perf_counter()
    with mock.patch.object(analytic, "kernels", walks):
        counts, sets, recs, kept, peak = _run_asr_cli(argv, sites)
    wall = time.perf_counter() - t
    train = [r for r in recs if r["tag"] == "train"]
    assert [r["step"] for r in train] == list(range(1, updates + 1))
    assert all(math.isfinite(r["loss_total"]) and math.isfinite(
        r["grad_norm"]) and r["skipped"] == 0.0 for r in train), train
    # dense attention everywhere: no K1, K2 or K3; K4 and the warp set's
    # two fused walks in every update
    assert counts["chunk_cache_attention"] == counts[
        "blockwise_flash_attention_packed"] == counts[
        "blockwise_flash_attention_bwd"] == 0, counts
    assert counts["hw_dropout"] > 0 and all(
        counts[w] > 0 and counts[w + "_block"] == 0 for w in WALKS), counts
    ups = None
    if updates > ASR_WARM:
        ups = ASR_TIMED / (train[-1]["at"] - train[ASR_WARM - 1]["at"])
    return counts, recs, peak, ups, wall


def _hold_walks(lattices, V):
    """Phase 5's comparison (``_hold_lattice``, then the loss and its
    gradient against float64 twins) at every lattice [B, G, U] that a
    phase's training calls walked, over V symbols -> {walk: max |diff|
    against its twin}; the worst of each walk's errors printed."""
    import torch

    dev = torch.device("cuda")
    worst = {}
    keys = {"forward_walk": ("forward_walk alphas", "forward_walk ad"),
            "reverse_walk": ("reverse_walk betas", "reverse_walk bd")}
    f64_keys = {"forward_walk": ("walk a", "walk ad"),
                "reverse_walk": ("walk b", "walk bd")}
    for i, (B, G, U) in enumerate(sorted(lattices)):
        lat = _hold_lattice(dev, B, G, U, V, i, "family lattice")
        _check_loss(_loss_grad(lat), lat.acts, (B, G, U, V),
                    "family lattice")
        for walk in keys:
            for k in (*keys[walk], walk):
                err = lat.errs.get(k, lat.abs_errs.get(k))
                worst[k] = max(worst.get(k, 0.0), err)
            for k in f64_keys[walk]:
                worst["f64 " + k] = max(worst.get("f64 " + k, 0.0),
                                        lat.f64[k])
        del lat
    torch.cuda.empty_cache()
    print(f"phase family walks: the fused walks at the {len(lattices)} "
          f"lattices [B, G, U] of the phase's training calls "
          f"{sorted((s, sorted(w)) for s, w in lattices.items())}, V {V}; "
          f"the worst over them: "
          + "; ".join(
              f"{walk}: max |diff| vs twin {worst[walk]:.3g}, err/(1+|x|) "
              f"vs twin " + ", ".join(
                  f"{k.split()[1]} {worst[k]:.3g} (tol {LAT_TOL[k]:g})"
                  for k in keys[walk])
              + ", vs float64 " + ", ".join(
                  f"{k} {worst['f64 ' + k]:.3g}" for k in f64_keys[walk])
              for walk in keys))
    return {walk: worst[walk] for walk in keys}


def _collate_ms(yaml, overrides):
    """{features: host ms of ``CaatBatcher.collate`` of the manifest's
    first 8 rows (mean of 3)} for fbank (log-mel, Whiten, TFMask) and raw
    audio."""
    from wav2vec_s_tpu_torch.train import cli, config

    out = {}
    for features in ("fbank", "raw"):
        cfg = config.load_config(yaml, [*overrides,
                                        f"data.features={features}"])
        batcher = cli._s2t_data(cfg)[2]
        t = time.perf_counter()
        for _ in range(3):
            batcher.collate(np.arange(8))
        out[features] = round((time.perf_counter() - t) / 3 * 1e3, 2)
    return out


def phase_family_full(card):
    """18b-d: the fbank and text families at full width through the entry
    points a user calls; then K4 against its twin at every dropout site's
    shape and rate of 18b-c -> ({path: launch counts}, K4's max abs
    error, {walk: its max abs error at the lattices of 18b-c})."""
    import pathlib
    import tempfile

    import torch
    from wav2vec_s_tpu_torch.data.batching import bucket_for, length_buckets
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    torch.cuda.empty_cache()
    S = int(SECONDS * 16000)
    total = ASR_WARM + ASR_TIMED
    yaml = os.path.join(CONFIGS, "caat_simulasr_base.yaml")
    paths, sites, lattices = {}, set(), {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        train, valid, bitext = _family_corpus(root)
        print(f"phase family full: {FAMILY_CLIPS} + {FAMILY_VALID} wavs of "
              f"{SECONDS:g} s, {FAMILY_SIMUL} of 4 s, {FAMILY_PAIRS} "
              f"sentence pairs and the dict written in "
              f"{time.perf_counter() - t:.1f} s")
        # the word tokenizer: no sentencepiece on the card's machine;
        # run.w2v2_model_path names no file: the fbank family ignores it
        common = ["--config", yaml, "--device", "cuda", "data.tokenizer=word",
                  f"data.vocab={root}/words.txt", "run.log_interval=1",
                  "run.save_interval_updates=0", "run.keep_last=1"]
        fbank = [*common, "data.features=fbank", f"data.max_tokens={8 * S}",
                 f"data.max_sample_size={S}", f"data.train_manifest={train}",
                 "run.w2v2_model_path=/no/such/wav2vec_s_base.pt"]

        # 18b: shallow2d + MHA, 12 updates and one validation with its
        # greedy decode (run.eval_bleu: run.eval_wer decodes for CTC only,
        # in both packages)
        counts, recs, peak, ups, wall = _family_call(
            [*fbank, "caat.frontend=shallow2d", "caat.jointer_type=mha",
             f"data.valid_manifest={valid}", "run.eval_bleu=true",
             f"run.validate_interval_updates={total}",
             f"run.max_update={total}", f"run.save_dir={root}/fbank"],
            sites, lattices, total)
        (vrec,) = [r for r in recs if r["tag"] == "valid"]
        assert np.isfinite(vrec["valid_loss"]), vrec
        frames = (S - 400) // 160 + 1
        bucket = bucket_for(frames, length_buckets(S // 160, multiple=16))
        losses = [r["loss_total"] for r in recs if r["tag"] == "train"]
        paths["fbank_cli"] = counts
        print(f"phase family full: fbank_cli: configs/caat_simulasr_base."
              f"yaml, data.features=fbank, shallow2d + mha, Base + CAAT "
              f"base, bf16, the recipe's dropouts, B 8 x {SECONDS:g} s "
              f"({frames} log-mel frames in a bucket of {bucket}): "
              f"launches {counts}; per update K4 "
              f"{counts['hw_dropout'] / total:.1f}, forward walks "
              f"{counts['transducer_forward_walk'] / total:.2f}, reverse "
              f"walks {counts['transducer_reverse_walk'] / total:.2f} (the "
              f"validation's loss adds forward walks); {ASR_WARM} warm + "
              f"{ASR_TIMED} timed updates -> {ups:.3f} updates/s "
              f"({8 * SECONDS * ups:.2f} audio-sec/s), peak memory "
              f"{peak:.3f} GB, loss {losses[0]:.2f} -> {losses[-1]:.2f}, "
              f"validation {vrec}; the whole call {wall:.1f} s [{card}]")
        print(f"phase family full: host ms of one training collate of 8 "
              f"wavs of {SECONDS:g} s (mean of 3; the prefetch thread runs "
              f"it beside the update's dispatch): "
              f"{_collate_ms(yaml, common[4:] + fbank[len(common):])} "
              f"[{card}]")
        torch.cuda.empty_cache()
        for frontend, jointer in FAMILY_VARIANTS:
            name = f"{frontend}+{jointer}"
            counts, recs, peak, _, wall = _family_call(
                [*fbank, f"caat.frontend={frontend}",
                 f"caat.jointer_type={jointer}", "run.max_update=1",
                 f"run.save_dir={root}/{name}"], sites, lattices, 1)
            print(f"phase family full: fbank {name}: one update at full "
                  f"width, B 8 x {SECONDS:g} s, loss "
                  f"{recs[0]['loss_total']:.2f}, peak memory {peak:.3f} GB, "
                  f"launches {counts}; the whole call {wall:.1f} s [{card}]")
            torch.cuda.empty_cache()

        # 18c: the text family, B 16 (every source 58-61 tokens)
        counts, recs, peak, ups, wall = _family_call(
            [*common, "data.features=text", f"data.train_manifest={bitext}",
             f"data.max_tokens={16 * (FAMILY_SRC[1])}",
             f"run.max_update={total}", f"run.save_dir={root}/text"],
            sites, lattices, total)
        losses = [r["loss_total"] for r in recs]
        paths["text_cli"] = counts
        print(f"phase family full: text_cli: data.features=text, Base "
              f"encoder widths + CAAT base, bf16, the recipe's dropouts, "
              f"B 16 pairs (sources of 58-61 tokens, targets of 21-61): "
              f"launches {counts}; per update K4 "
              f"{counts['hw_dropout'] / total:.1f}, forward walks "
              f"{counts['transducer_forward_walk'] / total:.2f}, reverse "
              f"walks {counts['transducer_reverse_walk'] / total:.2f}; "
              f"{ASR_WARM} warm + {ASR_TIMED} timed updates -> {ups:.3f} "
              f"updates/s, peak memory {peak:.3f} GB, loss "
              f"{losses[0]:.2f} -> {losses[-1]:.2f}; the whole call "
              f"{wall:.1f} s [{card}]")
        torch.cuda.empty_cache()

        # 18d: eval.cli simul on 18b's checkpoint
        t = time.perf_counter()
        lines, counts, _, _ = _eval_cli(
            ["simul", "--config", yaml, "--device", "cuda", "--ckpt-dir",
             f"{root}/fbank", "--manifest", str(root / "simul.tsv"),
             "data.features=fbank", "data.tokenizer=word",
             f"data.vocab={root}/words.txt"])
        wall = time.perf_counter() - t
        (scores,) = lines
        assert scores["num_instances"] == FAMILY_SIMUL and all(
            np.isfinite(scores[k]) for k in ("AL", "AP", "DAL", "BLEU"))
        assert not any(counts.values()), counts       # eager, dense, no loss
        paths["fbank_simul"] = counts
        print(f"phase family full: fbank_simul: eval.cli simul on "
              f"fbank_cli's checkpoint, {FAMILY_SIMUL} streams of 4 s: "
              f"{json.dumps(scores)}; AL {scores['AL']:.1f} ms; the whole "
              f"call {wall:.1f} s -> {FAMILY_SIMUL * 4.0 / wall:.2f} "
              f"audio-sec/s (cold: checkpoint read and model build "
              f"included) [{card}]")
        V = len(Dictionary.load(root / "words.txt"))
    return paths, _hold_sites(sites, "family"), _hold_walks(lattices, V)



# phase 19: the full-context wav2vec 2.0 encoder (the group-norm front-end,
# a stock-layout .pt, continued pre-training) and the wait-k and MMA
# simultaneous baselines
FULL_B, FULL_CALLS = 8, 5          # the full-context forward: B 8 x 10 s
BASELINE_K, BASELINE_STRIDE = 3, 8
BASELINE_WARM, BASELINE_TIMED = 1, 4
BASELINE_STREAMS, BASELINE_STREAM_S = 2, 4.0
BASELINE_MAX_LEN = 40
#: (seconds, targets) of the MMA updates that must train (every loss
#: finite, every update applied): at 10 s, U 40 the expected alignment of
#: the seeded model overflows (ROADMAP Queue 3)
MMA_FINITE = (1.0, 10)
BASELINE_CASES = (("waitk", "dense", False), ("waitk", "flash", False),
                  ("mma", "dense", False), ("mma", "flash", False),
                  ("mma", "flash", True))


def phase_baseline_parity():
    """19a (``tools/baseline_parity.py``): the tiny group-norm model on the
    full-context and the blockwise encoder (``extract_features``, the
    pre-training loss and every gradient), the wait-k and MMA training loss
    and every gradient (dense and flash, the recipe's dropouts; MMA without
    and with its energy noise), ``hard_decode_step``, and the two agents'
    words and delays: the card against the CPU."""
    import torch
    from wav2vec_s_tpu_torch.tools import baseline_parity as bp

    rtol, atol = bp.GRAD_TOL
    for encoder_type in ("full", "blockwise"):
        (lc, gc, fc), (lg, gg, fg) = (bp.full_context(dev, encoder_type)
                                      for dev in ("cpu", "cuda"))
        torch.testing.assert_close(fg, fc, rtol=1e-5, atol=1e-5)
        rel, worst = bp.gap((lc, gc), (lg, gg))
        print(f"phase baseline parity: tiny group-norm model, "
              f"{encoder_type} encoder, float32: extract_features max abs "
              f"diff {(fg - fc).abs().max().item():.3g}; pre-training loss "
              f"cpu {lc:.6f} cuda {lg:.6f} (rel diff {rel:.3g}, tol "
              f"{bp.LOSS_RTOL:g}); every gradient within {worst:.3g} of the "
              f"bound |diff| <= {rtol:g} |g| + {atol:g} max |g|")
        assert rel <= bp.LOSS_RTOL and worst <= 1.0, (encoder_type, rel,
                                                      worst)
    for kind, impl, noise in BASELINE_CASES:
        cpu = bp.loss_and_grads(kind, impl, "cpu", noise)
        _reset_counts()
        card = bp.loss_and_grads(kind, impl, "cuda", noise)
        counts = _counts()
        assert counts["hw_dropout"] > 0, counts
        k2k3 = (counts["blockwise_flash_attention_packed"],
                counts["blockwise_flash_attention_bwd"])
        assert (min(k2k3) > 0) == (impl == "flash"), (kind, impl, counts)
        rel, worst = bp.gap(cpu, card)
        label = f"{kind}, {impl}" + (", energy noise" if noise else "")
        print(f"phase baseline parity: tiny {label}, float32, the recipe's "
              f"dropouts: loss cpu {cpu[0]:.6f} cuda {card[0]:.6f} (rel "
              f"diff {rel:.3g}); every gradient within {worst:.3g} of the "
              f"bound; K4 {counts['hw_dropout']}, K2 {k2k3[0]}, K3 "
              f"{k2k3[1]} launches")
        assert rel <= bp.LOSS_RTOL and worst <= 1.0, (label, rel, worst)
    (lc, nc), (lg, ng) = bp.hard_step("cpu"), bp.hard_step("cuda")
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
    assert torch.equal(ng, nc)
    cpu, card = bp.agents("cpu"), bp.agents("cuda")
    assert card == cpu and all(text for _, text, _ in card), (cpu, card)
    print(f"phase baseline parity: hard_decode_step logits max abs diff "
          f"{(lg - lc).abs().max().item():.3g}, need_more {ng.tolist()} "
          f"equal; WaitkAgent and MMAStreamingAgent cuda == cpu: "
          f"{[(name, text, delays) for name, text, delays in card]}")


def _full_context_forward(model, card):
    """The full-context ``extract_features`` of a bf16 copy of ``model`` on
    B 8 x 10 s -> (launch counts of the timed calls, ms per call, peak
    GB)."""
    import torch
    from wav2vec_s_tpu_torch.models.feature_extractor import (
        conv_output_length)
    from wav2vec_s_tpu_torch.models.modules import compute_copy

    m = compute_copy(model, torch.bfloat16).cuda().eval()
    S = int(SECONDS * 16000)
    g = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randn((FULL_B, S), generator=g, device="cuda") * 0.1
    with torch.no_grad():
        out, _ = m.extract_features(src)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        ms = _cuda_ms(lambda: m.extract_features(src), FULL_CALLS)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = model.cfg
    frames = conv_output_length(S, cfg.conv_feature_layers)
    assert out.shape == (FULL_B, frames, cfg.encoder_embed_dim)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    # dense attention, no dropout: no kernel of the port runs here
    assert all(v == 0 for v in counts.values()), counts
    print(f"phase full context: extract_features, wav2vec 2.0 Base (group "
          f"norm, conv positions 128/16, 12 x 768, dense attention), bf16, "
          f"B {FULL_B} x {SECONDS:g} s (T {frames}): {ms:.3f} ms per call "
          f"({FULL_B * SECONDS / ms * 1e3:.1f} audio-sec/s), peak memory "
          f"{peak:.3f} GB over the calls [{card}]")
    del m
    torch.cuda.empty_cache()
    return counts, ms, peak


def phase_full_context(card):
    """19b: a stock-layout wav2vec 2.0 Base ``.pt`` (weight-normed conv
    positions, the block-0 group norm) from a seed through the port's
    export; ``convert_cli --encoder-type full`` round trip; the
    full-context forward at B 8 x 10 s; then continued pre-training
    through the trainer (configs/pretrain_base.yaml,
    ``model.extractor_mode=default``, ``run.load_pretrained_model_from``,
    flash): 2 warm + 10 timed updates; then K4 against its twin at every
    (shape, dtype, rate) the updates dropped -> ({path: launch counts},
    K4's max abs error)."""
    import math
    import pathlib
    import tempfile
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.checkpoint import convert_cli
    from wav2vec_s_tpu_torch.checkpoint.io import load_params
    from wav2vec_s_tpu_torch.checkpoint.torch_export import (
        export_wav2vec2_state_dict, save_fairseq_checkpoint)
    from wav2vec_s_tpu_torch.checkpoint.torch_import import (
        load_torch_checkpoint)
    from wav2vec_s_tpu_torch.models import (
        Wav2Vec2Model, wav2vec2_base_config)
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.train import cli

    torch.cuda.empty_cache()
    paths = {}
    t = time.perf_counter()
    model = random_init_(Wav2Vec2Model(wav2vec2_base_config(
        dtype="bfloat16"), pretraining=True, encoder_type="full"),
                         torch.Generator().manual_seed(0))
    sd = export_wav2vec2_state_dict(model)
    for key in ("encoder.pos_conv.0.weight_g", "encoder.pos_conv.0.weight_v",
                "feature_extractor.conv_layers.0.2.weight",
                "quantizer.vars", "mask_emb"):
        assert key in sd, key
    assert sd["encoder.pos_conv.0.weight_g"].shape == (1, 1,
                                                       model.cfg.conv_pos)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        pt = root / "wav2vec2_base.pt"
        # the stored cfg of a fairseq checkpoint: convert_cli reads the
        # widths and the extractor mode from it
        save_fairseq_checkpoint(pt, sd, {"model": {k: getattr(model.cfg, k)
                                                   for k in (
            "extractor_mode", "encoder_layers", "encoder_embed_dim",
            "encoder_ffn_embed_dim", "encoder_attention_heads", "final_dim",
            "latent_vars", "latent_groups")}})
        made = time.perf_counter() - t
        t = time.perf_counter()
        convert_cli.main(["--pt", str(pt), "--out", str(root / "ck"),
                          "--encoder-type", "full"])
        got = load_params(root / "ck")
        own = model.state_dict()
        assert sorted(got) == sorted(own)
        assert all(torch.equal(got[k], v) for k, v in own.items())
        convert_cli.main(["--export-from", str(root / "ck"), "--out",
                          str(root / "back.pt")])
        back = load_torch_checkpoint(root / "back.pt")["model"]
        assert sorted(back) == sorted(sd)
        assert all(torch.equal(back[k], v) for k, v in sd.items())
        print(f"phase full context: a stock-layout wav2vec 2.0 Base .pt "
              f"({len(sd)} tensors, {sum(v.numel() for v in sd.values())} "
              f"values: weight_g / weight_v, the block-0 group norm, the "
              f"quantizer) made from seed 0 in {made:.1f} s; convert_cli "
              f"--encoder-type full: the imported parameters == the model's "
              f"({len(got)} tensors), the exported .pt == the input, value "
              f"for value; {time.perf_counter() - t:.1f} s")

        paths["full_context_forward"], _, _ = _full_context_forward(model,
                                                                    card)
        del model
        manifest = _pretrain_corpus(root)
        total = PRETRAIN_WARM + PRETRAIN_TIMED
        argv = ["--config", os.path.join(CONFIGS, "pretrain_base.yaml"),
                "--device", "cuda", f"run.save_dir={root}/cont",
                f"run.max_update={total}", "run.log_interval=1",
                "run.save_interval_updates=0", "run.keep_last=1",
                "run.validate_interval_updates=0",
                f"data.train_manifest={manifest}",
                "model.attention_impl=flash", "model.extractor_mode=default",
                "model.pos_type=conv",
                f"run.load_pretrained_model_from={pt}"]
        snap = {}
        real_create = cli.TrainState.create

        def create(m, optimizer, plan=None, **kw):
            snap.update({k: v.detach().cpu().clone()
                         for k, v in m.state_dict().items()})
            return real_create(m, optimizer, plan, **kw)

        sites = set()
        t = time.perf_counter()
        with mock.patch.object(cli.TrainState, "create", create):
            counts, recs, ctxs, _, _, peak_gb = _run_pretrain_cli(argv,
                                                                  sites)
        wall = time.perf_counter() - t
    # the run started from the .pt: its group norm and encoder, no
    # conv positions (the blockwise encoder adds sinusoidal ones)
    want = {k: v for k, v in sd.items() if not k.startswith(
        "encoder.pos_conv.")}
    assert sorted(snap) == sorted(want), set(snap) ^ set(want)
    assert all(torch.equal(snap[k], v) for k, v in want.items())
    assert [r["step"] for r in recs] == list(range(1, total + 1))
    assert all(math.isfinite(r["loss_total"]) and math.isfinite(
        r["grad_norm"]) and r["skipped"] == 0.0 for r in recs), recs
    kept = [(c.sites - 3) // 3 for c in ctxs]
    flash_calls = sum(kept)
    assert counts["blockwise_flash_attention_packed"] == flash_calls
    assert counts["blockwise_flash_attention_bwd"] == flash_calls
    assert counts["hw_dropout"] == 2 * (sum(c.sites for c in ctxs)
                                        - flash_calls) > 0, counts
    span = recs[-1]["at"] - recs[PRETRAIN_WARM - 1]["at"]
    ups = PRETRAIN_TIMED / span
    per = {k: v / total for k, v in counts.items() if v}
    print(f"phase full context: continued pre-training (configs/"
          f"pretrain_base.yaml, model.extractor_mode=default, "
          f"run.load_pretrained_model_from=<that .pt>, flash, bf16, B "
          f"{PRETRAIN_B} x 200960 samples, sampled contexts): the model "
          f"before its first update == the .pt's weights ({len(want)} "
          f"tensors, the group norm kept, the conv positions dropped); "
          f"{PRETRAIN_WARM} warm + {PRETRAIN_TIMED} timed updates in "
          f"{span:.4f} s -> {ups:.3f} updates/s, peak memory {peak_gb:.3f} "
          f"GB; launches per update {per} (layers kept {kept}); loss "
          f"{recs[0]['loss_total']:.2f} -> {recs[-1]['loss_total']:.2f}; "
          f"the whole call {wall:.1f} s [{card}]")
    paths["pretrain_from_pt"] = counts
    return paths, _hold_sites(sites, "full context")


def _baseline_model(kind):
    import torch
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import caat_base_config
    from wav2vec_s_tpu_torch.models.mma import MMAModel
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.models.waitk import WaitkModel

    dev = torch.device("cuda")
    w2v = wav2vec_s_base_config(dtype="bfloat16", attention_impl="flash")
    caat = caat_base_config(dtype="bfloat16")
    with dev:
        model = (WaitkModel(w2v, caat, BASELINE_K, BASELINE_STRIDE)
                 if kind == "waitk" else MMAModel(w2v, caat))
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    return model


def _baseline_updates(kind, model, card, sites, seconds=None,
                      n_targets=None):
    """BASELINE_WARM + BASELINE_TIMED updates by hand of the baseline's
    ``sequence_loss`` (MMA: with its latency term and energy noise) on B 8
    x ``seconds`` (SECONDS), U ``n_targets`` (TRAIN_U) -> (launch counts
    of the timed updates, updates/s, peak GB).  Every timed loss must be finite and every update
    applied, except MMA's at 10 s (ROADMAP Queue 3: the expected alignment
    kept from JAX has no bound there)."""
    import math

    import torch
    from wav2vec_s_tpu_torch.ops.dropout import DropoutContext
    from wav2vec_s_tpu_torch.tools.baseline_parity import sequence_loss
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    seconds, n_targets = seconds or SECONDS, n_targets or TRAIN_U
    caat = model.cfg
    S = int(seconds * 16000)
    batch = _train_batch(TRAIN_B, S, n_targets, caat.vocab_size, caat.eos,
                         "cuda")
    kept = []
    Recorded = recording_context(sites, kept)

    def loss_fn(b, gen, step):
        ctx = Recorded(gen)
        n = (b["targets"] != caat.pad).sum()
        loss = sequence_loss(kind, model, b, ctx) * n
        return loss, n, {"loss": loss.detach()}

    opt = build_optimizer(OptimConfig(lr=1e-4, warmup_updates=100))
    state = TrainState.create(model, opt)
    step = make_train_step(loss_fn, opt)
    gen = torch.Generator().manual_seed(0)
    for _ in range(BASELINE_WARM):
        state, logs = step(state, batch, gen)
    torch.cuda.synchronize()
    before = {n: p.detach().clone()
              for n, p in model.decoder.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    kept.clear()
    t = time.perf_counter()
    all_logs = []
    for _ in range(BASELINE_TIMED):
        state, logs = step(state, batch, gen)
        all_logs.append(logs)
    torch.cuda.synchronize()
    span = time.perf_counter() - t
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(lg["loss_total"]) / float(lg["sample_size"])
              for lg in all_logs]
    skipped = [float(lg["skipped"]) for lg in all_logs]
    unchanged = [n for n, p in model.decoder.named_parameters()
                 if torch.equal(p, before[n])]
    del before
    if kind == "mma" and seconds == SECONDS:
        # ROADMAP Queue 3: the expected alignment kept from JAX has no
        # bound; at 10 s its mass overflows and the step skips the update
        # of a non-finite loss, and only then
        assert all(math.isfinite(v) == (k == 0.0)
                   for v, k in zip(losses, skipped)), all_logs
    else:
        assert all(math.isfinite(v) for v in losses) and not any(
            skipped), all_logs
        assert not unchanged, ("updates not applied to", unchanged)
    # one K2 forward and one K3 backward per kept encoder layer
    assert counts["hw_dropout"] > 0, counts
    assert counts["blockwise_flash_attention_packed"] == counts[
        "blockwise_flash_attention_bwd"] == sum(kept) > 0, (counts, kept)
    _on_tensor_cores(_set_paths(), {
        "K1": 0, "K2": counts["blockwise_flash_attention_packed"],
        "K3": counts["blockwise_flash_attention_bwd"]})
    mass = ""
    if kind == "mma":
        # the expected alignment's mass per target step: at most 1 in
        # exact arithmetic, more where the recursion's clips act
        tgt = batch["targets"]
        prev = torch.cat([torch.full_like(tgt[:, :1], caat.eos),
                          tgt[:, :-1]], dim=1)
        with torch.no_grad():
            _, alphas = model(batch["source"], prev, ctx=DropoutContext(
                torch.Generator().manual_seed(1)))
        # layer 0 reads clean inputs; later layers read its output
        m = alphas[0].float().sum(-1).amax(dim=(0, 1))            # [U]
        bad = (~torch.isfinite(m)).nonzero()
        steps = tuple(sorted({u for u in (0, 1, 2, 5, 10, 20)
                              if u < n_targets} | {n_targets - 1}))
        at = ", ".join(f"{m[u].item():.3g}" for u in steps)
        mass = (f"; layer 0's expected-alignment mass per target step "
                f"(max over rows and heads) at steps {steps}: {at}; "
                f"first non-finite step "
                f"{int(bad[0]) if len(bad) else None}; every layer finite: "
                f"{bool(torch.isfinite(alphas).all())}")
        del alphas
    ups = BASELINE_TIMED / span
    per = {k: v / BASELINE_TIMED for k, v in counts.items() if v}
    what = ("token NLL" if kind == "waitk" else
            "token NLL + 0.1 latency_loss, energy noise on")
    rate = (f"{ups:.3f} updates/s" if not any(skipped) else
            f"{ups:.3f} skipped updates/s (forward + backward, no "
            f"optimizer step)")
    print(f"phase baselines full: {kind} (wav2vec-S Base mc 16 rc 8, flash "
          f"+ CAAT-base decoder widths: 6 x 768, 12 heads, vocab "
          f"{caat.vocab_size}"
          + (f"; k {BASELINE_K}, stride {BASELINE_STRIDE}"
             if kind == "waitk" else "") +
          f"), bf16, the recipe's dropouts, {what}: B {TRAIN_B} x "
          f"{seconds:g} s, U {n_targets}: {BASELINE_WARM} warm + "
          f"{BASELINE_TIMED} timed updates in {span:.4f} s -> {rate} "
          f"({TRAIN_B * seconds * ups:.2f} audio-sec/s), peak memory "
          f"{peak:.3f} GB; launches per update {per}, K2/K3 all on the "
          f"tensor-core kernels (encoder layers kept {kept}); loss per "
          f"token {losses[0]:.3f} -> {losses[-1]:.3f}, updates skipped "
          f"(non-finite) {int(sum(skipped))} of {BASELINE_TIMED}, decoder "
          f"tensors unchanged by the updates {len(unchanged)}{mass} "
          f"[{card}]")
    return counts, ups, peak


def _baseline_agent(kind, model, card):
    """``WaitkAgent`` or ``MMAStreamingAgent`` under ``SimulEvaluator`` on
    BASELINE_STREAMS seeded-noise streams of 4 s -> launch counts."""
    import math
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.models.waitk import WaitkAgent
    from wav2vec_s_tpu_torch.stream.agent import SimulEvaluator
    from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
    from wav2vec_s_tpu_torch.stream.mma_agent import MMAStreamingAgent

    model.eval()
    vocab = _vocab(model.cfg.vocab_size)
    with torch.no_grad():
        # random weights: the eos row (tied to the output) scaled down so
        # that the agents write words before eos, and MMA's heads able to
        # stop (energy bias 0, not -2), as tools/baseline_parity.agents
        model.decoder.embed_tokens.weight[model.cfg.eos] *= 0.1
        if kind == "mma":
            for layer in model.decoder.layers:
                layer.encoder_attn.energy_bias.fill_(0.0)
    if kind == "waitk":
        def factory():
            return WaitkAgent(model, vocab, BASELINE_K, BASELINE_STRIDE,
                              max_len=BASELINE_MAX_LEN)
        counted, name, agent = WaitkAgent, "_emit_one", "WaitkAgent"
    else:
        def factory():
            return MMAStreamingAgent(model, vocab, main_context=16,
                                     right_context=8, eager=True,
                                     max_len=BASELINE_MAX_LEN)
        counted, name, agent = (StreamingEngine, "encode_prefix",
                                "MMAStreamingAgent")
    calls = [0]
    real = getattr(counted, name)

    def count(self, *a, **kw):
        calls[0] += 1
        return real(self, *a, **kw)

    wavs = _clips([int(BASELINE_STREAM_S * 16000)] * BASELINE_STREAMS,
                  seed=7)
    ev = SimulEvaluator(factory, segment_size_ms=25)
    with torch.no_grad():
        ev.run_instance(wavs[0][:16000], "w1")          # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        calls[0] = 0
        t = time.perf_counter()
        with mock.patch.object(counted, name, count):
            out = ev.evaluate(wavs, ["w1 w2 w3"] * len(wavs), metric="wer")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = _counts()
    k2 = counts["blockwise_flash_attention_packed"]
    assert calls[0] > 0 and k2 > 0 and k2 % calls[0] == 0, (k2, calls)
    assert counts["blockwise_flash_attention_bwd"] == 0, counts
    assert math.isfinite(out["AL"]), out
    what = ("a whole-model recompute per emission" if kind == "waitk"
            else "a prefix encode per policy step")
    print(f"phase baselines full: {agent} under "
          f"SimulEvaluator, {len(wavs)} streams of {BASELINE_STREAM_S:g} s "
          f"(25 ms segments), max_len {BASELINE_MAX_LEN}: "
          f"{len(wavs) * BASELINE_STREAM_S / wall:.3f} audio-sec/s "
          f"({wall:.2f} s), AL {out['AL']:.1f} ms, AP {out['AP']:.3f}; "
          f"{calls[0]} calls ({what}), K2 {k2} launches = {k2 // calls[0]} "
          f"per call [{card}]")
    return counts


def phase_baselines_full(card):
    """19c: wait-k and MMA at full width: training updates by hand and the
    two agents under ``SimulEvaluator``; then K4 against its twin at every
    (shape, dtype, rate) the updates dropped -> ({path: launch counts},
    K4's max abs error)."""
    import torch

    paths, sites = {}, set()
    for kind in ("waitk", "mma"):
        torch.cuda.empty_cache()
        model = _baseline_model(kind)
        paths[f"{kind}_train"], _, _ = _baseline_updates(kind, model, card,
                                                         sites)
        if kind == "mma":
            # a full-width MMA update that trains: a source short enough
            # for the expected alignment to stay finite (ROADMAP Queue 3)
            paths["mma_train_short"], _, _ = _baseline_updates(
                kind, model, card, sites, *MMA_FINITE)
        paths[f"{kind}_agent"] = _baseline_agent(kind, model, card)
        del model
    torch.cuda.empty_cache()
    return paths, _hold_sites(sites, "baselines")


# -- phase 20: tensor parallelism, the pipeline, sharded state under context
# parallelism, corpus preparation and the debug hooks ------------------------

# (dtype, mode, model width) of 20a's layouts, by world size
TP_JOBS = {2: {"f32 tp": ("float32", "dp", 2),
               "bf16 tp": ("bfloat16", "dp", 2)},
           4: {"bf16 tp fsdp": ("bfloat16", "fsdp", 2),
               "bf16 tp zero": ("bfloat16", "zero", 2)}}
PIPE_STAGES, PIPE_MICRO = 2, 8       # 20c: B 8 in 8 microbatches of 1 row
CP_UPDATES = 3                       # 20b
# 20b's learning rate, from the first update (no warmup: the schedule's
# warmup gives update 1 a rate of 0), so that each update moves every
# parameter by about it and a misapplied sharded update shows
CP_LR = 1e-3
PREP_CLIPS, PREP_WORDS = 16, 39      # 20d: a LibriSpeech-layout tree
DEBUG_UPDATES = 12
# 20c: the stages against apply_stacked in one process over the same
# microbatches: the loss, and each layer's gradient over its largest entry
PIPE_TOL = {"loss_rtol": 1e-5, "grad": 1e-2}
# 20b: run.seq=2 with ZeRO-1 / FSDP against run.seq=1: losses and grad
# norms within DDP_TOL (bfloat16); the split attention's GEMMs run over
# other row counts and round otherwise
CP_TOL = DDP_TOL["bfloat16"]
# 20b's parameters after CP_UPDATES updates: their mean |diff| to run.seq=1
# within this share of run.seq=1's own mean |update| (from the seeded
# initial weights), so that an update misapplied to a twentieth of the
# parameters (a ZeRO gather that misses the seq ranks, rows updated with
# another block's gradient) fails; the seq ranks' rounding alone gives
# ~0.005 on the H100
CP_PARAM_SHARE = 0.05


def _flash_heads(card):
    """K2 and K3 with a head base at the tensor-parallel call: a rank's
    heads 6-11 of 12 (D 384 of 768) on the rows 4: of the training batch
    (B 8, T 500 -> S 748, bfloat16, dropout 0.1, dropout_row0 4,
    dropout_h0 6, dropout_heads 12): output and gradients equal to the
    whole call's heads and rows bit for bit, the twins under the same base
    equal to the whole twin's; then both timed at the rank's call (B 8,
    6 heads) beside their bounds, twins and library call -> {K2, K3: (ms,
    plain ms, bound, library ms)}."""
    import torch
    import torch.nn.functional as F
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        _keep_scale, blockwise_flash_attention_bwd,
        blockwise_flash_attention_bwd_ref, blockwise_flash_attention_packed,
        blockwise_flash_attention_ref)

    B, T, mc, rc, H, D = TRAIN_B, TRAIN_T, 16, 8, 12, 768
    r0, h0, Hl = 4, 6, 6
    dh = D // H
    S = block_layout(T, mc, rc).total_len
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    seed, offset, rate = DROPOUT_SEED, 23, 0.1
    q, k, v, do = (torch.randn((B, S, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
    pad[5, T - 10:T] = True
    lay = (pad, H, T, mc, rc)
    out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, rate, True,
                                                 seed, offset)
    grads = blockwise_flash_attention_bwd(q, k, v, out, do, m, l, *lay,
                                          rate, seed, offset)
    cols = slice(h0 * dh, (h0 + Hl) * dh)
    part = [t[r0:, :, cols].contiguous() for t in (q, k, v, do)]
    lay_p = (pad[r0:].contiguous(), Hl, T, mc, rc)
    base = dict(dropout_row0=r0, dropout_h0=h0, dropout_heads=H)
    _reset_counts()
    o, mp, lp = blockwise_flash_attention_packed(*part[:3], *lay_p, rate,
                                                 True, seed, offset, **base)
    got = blockwise_flash_attention_bwd(*part[:3], o, part[3], mp, lp,
                                        *lay_p, rate, seed, offset, r0, h0,
                                        H)
    torch.cuda.synchronize()
    _on_tensor_cores(_set_paths(), {"K2": 1, "K3": 1})
    assert torch.equal(o, out[r0:, :, cols])
    assert torch.equal(mp, m[r0:, h0:h0 + Hl])
    for a, b in zip(got, grads):
        assert torch.equal(a, b[r0:, :, cols])
    assert torch.equal(
        _keep_scale(B - r0, Hl, S, rate, seed, offset, dev, r0, h0, H),
        _keep_scale(B, H, S, rate, seed, offset, dev)[r0:, h0:h0 + Hl])
    valid = ~lay_p[0]
    want = blockwise_flash_attention_ref(*part[:3], *lay_p, rate, seed,
                                         offset, r0, h0, H)[0]
    err = (o[valid].float() - want[valid].float()).abs().max().item()
    assert err <= 2e-2, err
    ref = blockwise_flash_attention_bwd_ref(*part[:3], o, part[3], mp, lp,
                                            *lay_p, rate, seed, offset, r0,
                                            h0, H)
    errs = []
    for i, (a, b) in enumerate(zip(got, ref)):
        if i == 0:
            a, b = a[valid], b[valid]
        errs.append(((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item())
    assert max(errs) <= 1e-2, errs
    print(f"phase tp flash: heads {h0}:{h0 + Hl} of {H} on rows {r0}: of "
          f"{B} (dropout_h0 {h0}, dropout_heads {H}, dropout_row0 {r0}, "
          f"rate {rate}, S {S}): K2 output and row stats and K3 grads == "
          f"the whole call's heads and rows bit for bit; the twins' masks "
          f"under the head base == the whole twin's; forward max_abs_err "
          f"{err:.3g} (tol 2e-2), dQ, dK, dV max |diff| / max |grad| "
          f"{', '.join(f'{e:.3g}' for e in errs)} (tol 1e-2)")
    del out, m, l, grads, got, ref, want
    # timing: one rank's call, 6 heads of 64 over the whole batch
    q, k, v, do = (t[:, :, cols].contiguous() for t in (q, k, v, do))
    lay = (pad, Hl, T, mc, rc)
    kw = dict(dropout_h0=h0, dropout_heads=H)
    o, mp, lp = blockwise_flash_attention_packed(q, k, v, *lay, rate, True,
                                                 seed, offset, **kw)
    k2 = _cuda_ms(lambda: blockwise_flash_attention_packed(
        q, k, v, *lay, rate, True, seed, offset, **kw), 20)
    k3 = _cuda_ms(lambda: blockwise_flash_attention_bwd(
        q, k, v, o, do, mp, lp, *lay, rate, seed, offset, 0, h0, H), 20)
    k2_plain = _cuda_ms(lambda: blockwise_flash_attention_ref(
        q, k, v, *lay, rate, seed, offset, 0, h0, H), 3)
    k3_plain = _cuda_ms(lambda: blockwise_flash_attention_bwd_ref(
        q, k, v, o, do, mp, lp, *lay, rate, seed, offset, 0, h0, H), 3)
    qh, kh, vh, mask = _sdpa_inputs(q, k, v, pad, Hl, T, mc, rc)
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    doh = do.reshape(B, S, Hl, dh).transpose(1, 2)

    def library():
        oh = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                            dropout_p=rate)
        torch.autograd.grad(oh, leaves, doh)

    lib_fwd = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, dropout_p=rate), 20)
    lib_bwd = _cuda_ms(library, 20) - lib_fwd
    Dl, pairs = Hl * dh, _allowed_pairs(T, mc, rc)
    # bounds: K2 reads q, k, v and the mask and writes out, m, l, two
    # products over the allowed pairs; K3 as phase 3b's
    b2 = _bound(2 * 4 * B * S * Dl + 2 * 4 * B * Hl * S + B * S,
                4 * B * Dl * pairs, "bfloat16")
    b3 = _bound(2 * 8 * B * S * Dl + 2 * 4 * B * Hl * S + B * S,
                10 * B * Dl * pairs, "bfloat16")
    print(f"phase tp flash: one rank's call (B {B}, S {S}, {Hl} of {H} "
          f"heads of {dh}, bf16, dropout {rate}, tensor-core kernels): K2 "
          f"{k2:.4f} ms (twin {k2_plain:.4f}, library "
          f"scaled_dot_product_attention {lib_fwd:.4f}, bound "
          f"{b2[0]:.5f} ms by {b2[1]}); K3 {k3:.4f} ms (twin "
          f"{k3_plain:.4f}, library backward alone {lib_bwd:.4f}, bound "
          f"{b3[0]:.5f} ms by {b3[1]}) [{card}]")
    return {"K2": (k2, k2_plain, b2, lib_fwd), "K3": (k3, k3_plain, b3,
                                                      lib_bwd)}


def _encoder_stack(dev):
    """The Base encoder's 12 layers (random weights, seed 4, float32
    parameters) stacked, and its layer as a function of (stacked params,
    x) through the flash path (bfloat16 activations, no padding, dropouts
    0)."""
    import torch
    from torch.func import functional_call
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.modules import (
        FlashSpec, TransformerEncoderLayer, random_init_)
    from wav2vec_s_tpu_torch.parallel.pipeline import stack_layer_params

    cfg = wav2vec_s_base_config()
    g = torch.Generator(device=dev).manual_seed(4)
    with dev:
        layers = [random_init_(TransformerEncoderLayer(
            cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim,
            cfg.encoder_attention_heads), g)
            for _ in range(cfg.encoder_layers)]
    template = layers[0]

    def layer_fn(p, x):
        spec = FlashSpec(torch.zeros(x.shape[:2], dtype=torch.bool,
                                     device=x.device), TRAIN_T - 1, 16, 8)
        return functional_call(template, p,
                               (x, spec, cfg.layer_norm_first))
    return stack_layer_params(layers), layer_fn, cfg.encoder_embed_dim


def _pipe_inputs(dev, dim):
    import torch
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout

    S = block_layout(TRAIN_T - 1, 16, 8).total_len
    g = torch.Generator(device=dev).manual_seed(12)
    x, tgt = (torch.randn((TRAIN_B, S, dim), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    return x, tgt


def _pipe_loss(out, tgt):
    return ((out.float() - tgt.float()) ** 2).sum() / tgt.numel()


def _pipeline_rank(mesh):
    """20c on this rank: the stack over the pipe stages, 8 microbatches ->
    (loss, gradients summed over the stages, counts, wall s, peak GB)."""
    import torch
    import torch.distributed as dist
    from wav2vec_s_tpu_torch.parallel.pipeline import (
        local_rows, pipeline_apply)

    dev = torch.device("cuda")
    stacked, layer_fn, dim = _encoder_stack(dev)
    x, tgt = _pipe_inputs(dev, dim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t = time.perf_counter()
    out = pipeline_apply(layer_fn, stacked, x, mesh, PIPE_MICRO)
    loss = _pipe_loss(out, local_rows(tgt, mesh, PIPE_MICRO))
    loss.backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _counts()
    grads = {k: v.grad for k, v in stacked.items()}
    for gr in grads.values():
        dist.all_reduce(gr)
    return (loss.item(), {k: v.cpu() for k, v in grads.items()}, counts,
            wall, torch.cuda.max_memory_allocated() / 1e9)


def _cp_cli_rank(calls):
    """20b on this rank: each ``train.cli`` call of ``calls`` ({name:
    argv}) with the counts set to 0 before it -> {name: (progress
    records, counts, wall s, peak GB)}."""
    import io
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.train import cli
    from wav2vec_s_tpu_torch.utils.metrics import JsonProgress

    out = {}
    for name, argv in calls.items():
        records = []

        class Kept(JsonProgress):
            def __init__(self, **kw):
                super().__init__(stream=io.StringIO(), **kw)

            def log(self, stats, step, tag="train"):
                records.append(dict(stats, step=step, tag=tag))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t = time.perf_counter()
        with mock.patch.object(cli, "JsonProgress", Kept):
            cli.main(argv)
        torch.cuda.synchronize()
        out[name] = (records, _counts(), time.perf_counter() - t,
                     torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.empty_cache()
    return out


def _phase20_rank(rank, world, store, out, cli_calls):
    """One rank of 20a-c on cuda:0 over gloo: the tensor-parallel jobs of
    its world size (two CAAT updates by hand), then with 2 ranks the
    pipeline, with 4 the context-parallel trainer calls.  Every rank's
    logs, counts, times and sites are gathered to rank 0, which writes
    them with its own parameters, moments and gradients (the single-process
    layout, the same on every rank)."""
    from unittest import mock

    import torch
    import torch.distributed as dist
    from wav2vec_s_tpu_torch.parallel.mesh import (
        make_mesh, process_local_rows)
    from wav2vec_s_tpu_torch.parallel.sharding import ParallelPlan
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import recipes

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mine = {"tp": {}}
        for name, (dtype, mode, n_model) in TP_JOBS[world].items():
            mesh = make_mesh(world // n_model, n_model=n_model,
                             device_type="cuda", backend="gloo")
            plan = ParallelPlan(mesh, mode)
            rows = process_local_rows(TRAIN_B, mesh)
            sites = set()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            with mock.patch.object(recipes, "DropoutContext",
                                   recording_context(sites, index=True)):
                logs, params, mu, state = _ddp_updates(dtype, plan, rows)
            torch.cuda.synchronize()
            mine["tp"][name] = {
                "logs": logs, "params": params, "mu": mu,
                "counts": _counts(), "sites": sites,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "tp_keys": len(plan.tp_keys)}
            del state
            torch.cuda.empty_cache()
        if world == PIPE_STAGES:
            mesh = make_mesh(1, n_pipe=PIPE_STAGES, device_type="cuda",
                             backend="gloo")
            mine["pipe"] = _pipeline_rank(mesh)
        if cli_calls:
            mine["cli"] = _cp_cli_rank(cli_calls)
        light = {"tp": {n: {k: v for k, v in job.items()
                            if k not in ("params", "mu")}
                        for n, job in mine["tp"].items()}}
        if "pipe" in mine:
            light["pipe"] = mine["pipe"][:1] + (None,) + mine["pipe"][2:]
        if "cli" in mine:
            light["cli"] = mine["cli"]
        every = [None] * world
        dist.all_gather_object(every, light)
        if rank == 0:
            every[0] = mine
            torch.save(every, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn_ranks(fn, world, args, label):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 900
    try:
        while not ctx.join(timeout=30):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{label}: the ranks did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()


def _cp_calls(root):
    """20b's trainer calls at Base + CAAT base, bf16, dense attention, the
    recipe's dropouts, B 8 x 10 s: run.seq=1 (data 4), then run.seq=2 with
    run.zero, then with run.fsdp (data 2 x seq 2)."""
    S = int(SECONDS * 16000)
    tsv, vocab = _cli_corpus(root, CLI_CLIPS, S, 10000, CLI_WORDS)

    def argv(tag, *extra):
        return ["--device", "cuda", "run.task=caat",
                f"run.save_dir={root}/{tag}", f"run.max_update={CP_UPDATES}",
                "run.log_interval=1", "run.save_interval_updates=0",
                "run.keep_last=1", "run.validate_interval_updates=0",
                f"data.train_manifest={tsv}", f"data.vocab={vocab}",
                f"data.max_tokens={TRAIN_B * S}", f"data.max_sample_size={S}",
                f"optim.lr={CP_LR}", "optim.warmup_updates=0",
                "model.dtype=bfloat16", "model.attention_impl=dense",
                "caat.dtype=bfloat16", "caat.step_mode=constant", *extra]
    return {"seq1 dp": argv(_cp_tag("seq1 dp")),
            "seq2 zero": argv(_cp_tag("seq2 zero"), "run.seq=2",
                              "run.zero=true"),
            "seq2 fsdp": argv(_cp_tag("seq2 fsdp"), "run.seq=2",
                              "run.fsdp=true")}


def _cp_tag(name):
    """The save directory of a 20b call."""
    return name.replace(" ", "_")


def _rank_line(r, name):
    c = r["counts"]
    return (f"K2 {c['blockwise_flash_attention_packed']} K3 "
            f"{c['blockwise_flash_attention_bwd']} K4 {c['hw_dropout']} "
            f"walks {c['transducer_forward_walk']} / "
            f"{c['transducer_reverse_walk']}")


def phase_parallel_more(card, one, split):
    """20a-c: two ranks, then four, on cuda:0 over gloo.  (a) The CAAT
    step by hand (phase 16a's: Base + CAAT base, flash, the recipe's
    dropouts, B 8 x 10 s, U 40, two updates) under tensor parallelism:
    data 1 x model 2 in float32 and bfloat16, then data 2 x model 2 with
    FSDP and with ZeRO-1 in bfloat16, against phase 16a's one process over
    the 8 rows in the same dtype (``one``): loss and grad norm within
    DDP_TOL; Adam's first moments and the parameters, in float32, no
    further from it than phase 16a's split process (``split``) is (twice
    it, plus DDP_FLOOR); in bfloat16 (where a row-parallel product rounds
    each half before the sum) no further from the float32 one process
    than the bfloat16 one process is (twice it, plus DDP_FLOOR).  K2 and
    K3 with the head base held at the rank's call, K4 at every site the
    ranks dropped.  (b) The trainer with run.seq=2 and run.zero /
    run.fsdp (data 2 x seq 2), dense attention, 3 updates at CP_LR from
    the first, against run.seq=1 on the same 4 ranks (data 4, the same
    8-row batches): losses and grad norms within CP_TOL, the parameters'
    mean |diff| within CP_PARAM_SHARE of run.seq=1's mean |update|.  (c)
    The Base encoder's 12 layers (flash, dropouts 0) pipelined over 2
    stages, 8 microbatches of B 8 x 10 s, against apply_stacked in one
    process over the same microbatches -> ({path: rank 0's counts}, K4's
    max abs error, {K2, K3: the head-base call's timing})."""
    import math
    import pathlib
    import tempfile

    import torch
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.parallel.pipeline import apply_stacked
    from wav2vec_s_tpu_torch.train import cli
    from wav2vec_s_tpu_torch.train.config import load_config

    torch.cuda.empty_cache()
    timing = _flash_heads(card)
    torch.cuda.empty_cache()
    ranks = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        calls = _cp_calls(root)
        for world in (2, 4):
            out = os.path.join(tmp, f"ranks{world}.pt")
            t = time.perf_counter()
            _spawn_ranks(_phase20_rank, world,
                         (os.path.join(tmp, f"store{world}"), out,
                          calls if world == 4 else {}),
                         f"phase 20 ({world} ranks)")
            ranks[world] = torch.load(out, weights_only=False)
            print(f"phase parallel more: {world} ranks: "
                  f"{time.perf_counter() - t:.1f} s (spawn included)")
        final = {name: CheckpointManager(root / _cp_tag(name),
                                         keep_last=0).restore()[0]["model"]
                 for name in calls}
        # 20b's yardstick: the seeded initial weights the three calls
        # start from, built as the trainer builds them
        init = cli.build_caat(load_config(
            None, calls["seq1 dp"][2:]))[2].state_dict()
    paths, sites = {}, set()
    # (a) tensor parallelism
    for world, jobs in TP_JOBS.items():
        for name, (dtype, _, _) in jobs.items():
            tol = DDP_TOL[dtype]
            rs = [r["tp"][name] for r in ranks[world]]
            r = rs[0]
            d = _run_diff(r, one[dtype], tol)
            if dtype == "float32":      # the yardstick: the split process
                far = d
                ds = _run_diff(split[dtype], one[dtype], tol)
                yard = "phase 16a's split process"
            else:                       # the bfloat16 one process's own
                far = _run_diff(r, one["float32"], tol)
                ds = _run_diff(one[dtype], one["float32"], tol)
                yard = (f"against float32 {_diff_text(far)}; the bfloat16 "
                        f"one process against float32")
            per_rank = "; ".join(
                f"rank {i}: updates "
                f"{[round(x['update_s'], 3) for x in q['logs']]}"
                f" s, peak {q['peak_gb']:.2f} GB, {_rank_line(q, name)}"
                for i, q in enumerate(rs))
            print(f"phase tp: {name}, {world} ranks on one card over gloo "
                  f"(data {world // 2} x model 2, B 8 x {SECONDS:g} s, U "
                  f"{TRAIN_U}, flash, the recipe's dropouts, "
                  f"{r['tp_keys']} split tensors): loss "
                  f"{[x['loss_total'] for x in r['logs']]}, grad norm "
                  f"{[x['grad_norm'] for x in r['logs']]}; against one "
                  f"process over the 8 rows {_diff_text(d)} (tolerances "
                  f"{tol}; {yard} {_diff_text(ds)}); "
                  f"{per_rank} [{card}]")
            assert all(x["skipped"] == 0.0 for x in r["logs"])
            assert all(a["sample_size"] == b["sample_size"]
                       for a, b in zip(r["logs"], one[dtype]["logs"]))
            for q in rs:
                c = q["counts"]
                assert all(c[k] > 0 for k in (
                    "blockwise_flash_attention_packed",
                    "blockwise_flash_attention_bwd", "hw_dropout",
                    *WALKS)), (name, c)
                sites |= q["sites"]
            assert d["loss"] <= tol["loss_rtol"], d
            assert d["gnorm"] <= tol["grad_norm_rtol"], d
            assert far["mu"] <= 2 * ds["mu"] + DDP_FLOOR["mu"], (far, ds)
            floor = DDP_FLOOR["param_over_lr"] * DDP_LR
            assert far["pmax"] <= 2 * ds["pmax"] + floor, (far, ds)
            assert far["pmean"] <= 2 * ds["pmean"] + floor, (far, ds)
            paths["tp " + name] = r["counts"]
    k4_err = _hold_sites(sites, "tp")
    # (c) the pipeline
    dev = torch.device("cuda")
    stacked, layer_fn, dim = _encoder_stack(dev)
    x, tgt = _pipe_inputs(dev, dim)
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    per = TRAIN_B // PIPE_MICRO
    per_stage = next(iter(stacked.values())).shape[0] // PIPE_STAGES
    want_loss = 0.0
    for m in range(PIPE_MICRO):
        rows = slice(m * per, (m + 1) * per)
        loss = _pipe_loss(apply_stacked(layer_fn, stacked, x[rows]),
                          tgt[rows]) * per / TRAIN_B
        loss.backward()
        want_loss += loss.item()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t
    one_counts = _counts()
    whole = _pipe_loss(apply_stacked(layer_fn, {k: v.detach() for k, v in
                                                stacked.items()}, x),
                       tgt).item()
    errs = {k: ((ranks[2][0]["pipe"][1][k] - v.grad.cpu()).abs().max()
                / v.grad.abs().max().cpu()).item()
            for k, v in stacked.items()}
    worst = max(errs, key=errs.get)
    for i, r in enumerate(ranks[2]):
        loss, _, c, wall, peak = r["pipe"]
        print(f"phase pipeline: stage {i} of {PIPE_STAGES} ({per_stage} of "
              f"the Base encoder's layers, flash, bf16, dropouts 0; "
              f"{PIPE_MICRO} microbatches of {per} x {SECONDS:g} s): "
              f"loss {loss:.6f}, forward + backward {wall:.2f} s, peak "
              f"{peak:.2f} GB, K2 {c['blockwise_flash_attention_packed']} K3 "
              f"{c['blockwise_flash_attention_bwd']} [{card}]")
        assert abs(loss - want_loss) <= PIPE_TOL["loss_rtol"] * abs(
            want_loss), (loss, want_loss)
        assert (c["blockwise_flash_attention_packed"]
                == c["blockwise_flash_attention_bwd"]
                == per_stage * PIPE_MICRO), c
    print(f"phase pipeline: apply_stacked in one process over the same "
          f"microbatches: loss {want_loss:.6f} (over the whole batch at "
          f"once {whole:.6f}), {one_wall:.2f} s, K2 "
          f"{one_counts['blockwise_flash_attention_packed']}; the stages' "
          f"gradients (summed) against it: max |diff| / max |grad| "
          f"{errs[worst]:.3g} in {worst} (tol {PIPE_TOL['grad']}) [{card}]")
    assert errs[worst] <= PIPE_TOL["grad"], (worst, errs[worst])
    paths["pipeline"] = ranks[2][0]["pipe"][2]
    del stacked
    torch.cuda.empty_cache()
    # (b) context parallelism with sharded state, through the trainer
    runs = {name: ranks[4][0]["cli"][name] for name in calls}
    want, ref = runs["seq1 dp"][0], final["seq1 dp"]
    assert [r["step"] for r in want] == list(range(1, CP_UPDATES + 1))
    moved = {k: (v.float() - init[k].float()).abs() for k, v in ref.items()}
    step_mean = torch.cat([t.flatten() for t in moved.values()]).mean()
    for name in ("seq2 zero", "seq2 fsdp"):
        recs = runs[name][0]
        assert [r["step"] for r in recs] == [r["step"] for r in want]
        assert all(r["skipped"] == 0.0 and math.isfinite(r["loss_total"])
                   for r in recs + want), (recs, want)
        loss = max(abs(a["loss_total"] - b["loss_total"])
                   / abs(b["loss_total"]) for a, b in zip(recs, want))
        gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                    for a, b in zip(recs, want))
        per = {k: (final[name][k].float() - v.float()).abs()
               for k, v in ref.items()}
        diffs = torch.cat([t.flatten() for t in per.values()])
        share = (diffs.mean() / step_mean).item()
        # the tensor whose mean |diff| is the largest share of its own
        # mean |update| (of the tensors that moved)
        ratios = {k: (t.mean() / moved[k].mean()).item()
                  for k, t in per.items() if moved[k].mean() > 0}
        worst = max(ratios, key=ratios.get)
        per_rank = "; ".join(
            f"rank {i}: {r['cli'][name][2]:.1f} s, peak "
            f"{r['cli'][name][3]:.2f} GB, K4 "
            f"{r['cli'][name][1]['hw_dropout']} walks "
            f"{r['cli'][name][1]['transducer_forward_walk']}"
            for i, r in enumerate(ranks[4]))
        print(f"phase cp sharded: train.cli {name} on 4 ranks (data 2 x "
              f"seq 2, dense, bf16, the recipe's dropouts, B 8 x "
              f"{SECONDS:g} s), {CP_UPDATES} updates: loss "
              f"{[r['loss_total'] for r in recs]} against run.seq=1 (data "
              f"4) {[r['loss_total'] for r in want]}: max rel diff "
              f"{loss:.3g}, grad norm {gnorm:.3g} (tolerances {CP_TOL}); "
              f"params max |diff| {diffs.max().item():.3g} mean "
              f"{diffs.mean().item():.3g}, {share:.3g} of run.seq=1's mean "
              f"|update| {step_mean.item():.3g} (lr {CP_LR:g}, tolerance "
              f"{CP_PARAM_SHARE}; the largest share in one tensor "
              f"{ratios[worst]:.3g}, {worst}); {per_rank}; run.seq=1 "
              f"{runs['seq1 dp'][2]:.1f} s [{card}]")
        assert loss <= CP_TOL["loss_rtol"] and gnorm <= CP_TOL[
            "grad_norm_rtol"], (name, loss, gnorm)
        assert share <= CP_PARAM_SHARE, (name, share, worst)
        for r in ranks[4]:
            c = r["cli"][name][1]
            assert c["hw_dropout"] > 0 and c["transducer_forward_walk"] > 0
        paths["cp " + name] = runs[name][1]
    return paths, k4_err, timing


def _librispeech_tree(root, n, seconds, words, n_words, seed):
    """A seeded LibriSpeech-layout split (<root>/train/<spk>/<chapter>/
    <spk>-<ch>-<utt>.wav and per-chapter .trans.txt) of ``n`` wavs."""
    from wav2vec_s_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    for c in range(2):
        d = root / "train" / str(100 + c) / str(200 + c)
        d.mkdir(parents=True)
        lines = []
        for u in range(n // 2):
            uid = f"{100 + c}-{200 + c}-{u:04d}"
            write_wav(d / f"{uid}.wav", rng.standard_normal(
                int(seconds * 16000)).astype(np.float32) * 0.1)
            text = " ".join(words[j] for j in rng.integers(0, len(words),
                                                           n_words))
            lines.append(f"{uid} {text}")
        (d / f"{100 + c}-{200 + c}.trans.txt").write_text(
            "\n".join(lines) + "\n")


def phase_prep_debug(card):
    """20d: a seeded LibriSpeech-layout tree of 16 wavs of 10 s -> ``prep
    librispeech`` -> ``prep s2t`` -> ``preprocess`` (the word dictionary
    of the tsv's targets); the trainer on those files (Base + CAAT base,
    bf16, flash, the recipe's dropouts, B 8) for 12 updates with
    run.profile_dir and run.debug_nan: the trace of updates 10-12 names
    K2's and K4's kernels among its CUDA kernels; then a NaN planted in one
    parameter of the checkpoint and one more update: FloatingPointError
    naming it -> the path's counts."""
    import json as js
    import pathlib
    import tempfile

    import torch
    from wav2vec_s_tpu_torch.data import prep, preprocess
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.train import cli

    S = int(SECONDS * 16000)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        words = [f"w{i}" for i in range(200)]
        _librispeech_tree(root / "LibriSpeech", PREP_CLIPS, SECONDS, words,
                          PREP_WORDS, 3)
        out = root / "manifests"
        assert prep.main(["librispeech", str(root / "LibriSpeech"),
                          "--split", "train", "--out", str(out), "--ext",
                          "wav"]) == 0
        tsv = out / "train_asr.tsv"
        assert prep.main(["s2t", "--manifest", str(out / "train.tsv"),
                          "--wrd", str(out / "train.wrd"), "--out",
                          str(tsv), "--config-out",
                          str(out / "config.yaml")]) == 0
        preprocess.main(["--manifests", str(tsv), "--tokenizer", "word",
                         "--padding-factor", "8", "--out",
                         str(out / "dict.txt")])
        vocab = Dictionary.load(out / "dict.txt")
        prep_s = time.perf_counter() - t
        lines = tsv.read_text().splitlines()
        assert len(lines) == PREP_CLIPS + 1 and len(vocab) % 8 == 0
        print(f"phase prep: {PREP_CLIPS} LibriSpeech-layout wavs of "
              f"{SECONDS:g} s -> prep librispeech (manifest, .wrd, .ltr) -> "
              f"prep s2t ({len(lines) - 1} rows, config) -> preprocess "
              f"({len(vocab)} entries, padding factor 8) in {prep_s:.1f} s")
        prof = root / "profile"
        argv = ["--device", "cuda", "run.task=caat",
                f"run.save_dir={root}/ckpt", "run.log_interval=1",
                "run.save_interval_updates=0", "run.keep_last=1",
                "run.debug_nan=true", f"run.profile_dir={prof}",
                f"data.train_manifest={tsv}", f"data.vocab={out}/dict.txt",
                f"data.max_tokens={TRAIN_B * S}", f"data.max_sample_size={S}",
                "optim.lr=1e-4", "optim.warmup_updates=100",
                "model.dtype=bfloat16", "model.attention_impl=flash",
                "caat.dtype=bfloat16", "caat.step_mode=constant"]
        t = time.perf_counter()
        counts, recs, _, kept, peak_gb = _run_cli(
            argv + [f"run.max_update={DEBUG_UPDATES}"], 12, 12)
        wall = time.perf_counter() - t
        assert [r["step"] for r in recs] == list(range(1, DEBUG_UPDATES + 1))
        assert all(r["skipped"] == 0.0 for r in recs)
        assert counts["blockwise_flash_attention_packed"] == sum(kept) == \
            counts["blockwise_flash_attention_bwd"] > 0
        assert counts["hw_dropout"] > 0 and all(counts[w] > 0 for w in WALKS)
        trace = js.loads((prof / "trace.json").read_text())
        kernels = {e["name"] for e in trace["traceEvents"]
                   if e.get("cat") == "kernel"}
        k2 = sorted(n for n in kernels if "flash_fwd_mma_kernel" in n)
        k4 = sorted(n for n in kernels if "dropout_kernel" in n)
        print(f"phase debug: train.cli on the prepared files, "
              f"{DEBUG_UPDATES} updates with run.debug_nan and "
              f"run.profile_dir (B 8 x {SECONDS:g} s, flash, bf16): "
              f"{wall:.1f} s, peak {peak_gb:.2f} GB, loss "
              f"{recs[0]['loss_total']:.2f} -> {recs[-1]['loss_total']:.2f};"
              f" trace of updates 11-{DEBUG_UPDATES} "
              f"({(prof / 'trace.json').stat().st_size} bytes, "
              f"{len(kernels)} distinct CUDA kernels) names K2 {k2[:2]} and "
              f"K4 {k4[:2]} [{card}]")
        assert k2 and k4, sorted(kernels)[:40]
        ckpt = root / "ckpt" / f"step_{DEBUG_UPDATES:09d}" / "state.pt"
        payload = torch.load(ckpt, weights_only=False)
        name = "decoder.jointer.layers.0.fc1.weight"
        payload["model"][name][3, :5] = float("nan")
        torch.save(payload, ckpt)
        try:
            cli.main(argv + [f"run.max_update={DEBUG_UPDATES + 1}"])
        except FloatingPointError as e:
            msg = str(e)
        else:
            raise AssertionError("a planted NaN went through run.debug_nan")
        assert f"params['{name}']: 5/" in msg and msg.count("params[") == 1, (
            msg)
        print(f"phase debug: a NaN planted in 5 entries of {name}: the "
              f"resumed update raised FloatingPointError: {msg[:160]}")
    torch.cuda.empty_cache()
    return counts


# -- phase 21: rematerialization, the flat optimizer, the native reader ------

LARGE_CAAT = os.path.join(CONFIGS, "caat_simulasr_large.yaml")
REMAT_B, REMAT_U, REMAT_UPDATES = 4, 40, 3
REMAT_CUT = ("model.encoder_layers=4", "caat.decoder_layers=2",
             "caat.jointer_layers=2")
REMAT_LR = 1e-3
REMAT_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4,
             "param_over_lr": 1e-2}
#: 21a's runs: (label, run.remat, model.remat_extractor, optimizer, flat
#: optimizer ("raveled": the tree optimizer over the vector raveled and
#: padded every update, the JAX package's ravel), the run it must equal)
REMAT_RUNS = (
    ("none", "none", False, "adam", False, None),
    ("dots", "dots", False, "adam", False, "none"),
    ("nothing", "nothing", False, "adam", False, "none"),
    ("offload_dots", "offload_dots", False, "adam", False, "none"),
    ("extractor", "none", True, "adam", False, "none"),
    ("nothing+extractor", "nothing", True, "adam", False, "none"),
    ("flat adam", "none", False, "adam", True, "none"),
    ("adafactor raveled", "none", False, "adafactor", "raveled", None),
    ("flat adafactor", "none", False, "adafactor", True,
     "adafactor raveled"))
LARGE_CLIPS = 18           # 21b: two batches of 9 x 10 s (max_tokens)
LARGE_MAX_TOKENS = 1440000
#: 21b's calls of the trainer: (tag, overrides)
LARGE_CALLS = (("none", ()), ("dots", ("run.remat=dots",)),
               ("nothing+extractor", ("run.remat=nothing",
                                      "model.remat_extractor=True")),
               ("offload_dots", ("run.remat=offload_dots",)),
               ("flat", ("run.flat_optimizer=true",)))
READER_REPS = 5


def _large_caat(dev, *overrides):
    """(model on ``dev``, w2v config, caat config) of
    caat_simulasr_large.yaml under ``overrides``, random weights from seed
    0, a 10000-entry vocabulary."""
    import torch
    from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.train import cli, config

    w2v, caat = cli.caat_configs(config.load_config(LARGE_CAAT, overrides),
                                 10000)
    with dev:
        model = W2V2CaatModel(w2v, caat)
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    return model, w2v, caat


def _raveled_step(opt, loss_fn, model):
    """The train step with the tree optimizer over ONE parameter: the
    vector raveled (``torch.cat``) and padded to 64 every update, then cut
    back into the parameters: what the JAX package's flat path computes,
    without the flat views."""
    import math

    import torch

    params = list(model.parameters())
    n_all = sum(p.numel() for p in params)
    pad = (-n_all) % 64
    ostate = opt.init([params[0].new_zeros(n_all + pad)])

    def step(state_no, batch, generator):
        for p in params:
            p.grad = None
        loss, n, logs = loss_fn(batch, generator, state_no)
        loss.backward()
        with torch.no_grad():
            tail = [params[0].new_zeros(pad)]
            vec = torch.cat([p.reshape(-1) for p in params] + tail)
            g = torch.cat([(p.grad if p.grad is not None else
                            torch.zeros_like(p)).reshape(-1)
                           for p in params] + tail)
            g /= torch.clamp(torch.as_tensor(n, dtype=torch.float32,
                                             device=g.device), min=1.0)
            gnorm = torch.linalg.vector_norm(g)
            ok = math.isfinite(gnorm.item())
            if ok:
                opt.update([vec], [g], ostate, gnorm)
                off = 0
                for p in params:
                    p.copy_(vec[off:off + p.numel()].view_as(p))
                    off += p.numel()
        for p in params:
            p.grad = None
        return {"loss_total": loss.detach(), "grad_norm": gnorm,
                "skipped": torch.tensor(0.0 if ok else 1.0)}

    return step


def _remat_run(label, policy, extractor, optimizer, flat):
    """21a: ``REMAT_UPDATES`` updates of the cut Large model by hand ->
    {logs, params (on the card), generator state, per update (launch
    counts, [(seed, sites, layers kept)] of each DropoutContext), counts,
    peak GB above what the run found allocated (the reference runs' kept
    parameters), s}."""
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import recipes
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, w2v, caat = _large_caat(
        dev, *REMAT_CUT, "model.attention_impl=flash",
        f"model.remat_extractor={extractor}")
    opt = build_optimizer(OptimConfig(
        optimizer=optimizer, lr=REMAT_LR, clip_norm=25.0,
        lr_scheduler="polynomial_decay", warmup_updates=0,
        total_updates=100))
    contexts, kept = [], []
    with mock.patch.object(recipes, "DropoutContext",
                           recording_context(kept=kept, contexts=contexts)):
        loss_fn = recipes.make_caat_loss_fn(model, caat, 16, 8)
        if flat == "raveled":
            step = _raveled_step(opt, loss_fn, model)
        else:
            state = TrainState.create(model, opt, flat_optimizer=flat)
            train_step = make_train_step(loss_fn, opt, remat_policy=policy)

            def step(i, batch, generator):
                return train_step(state, batch, generator)[1]
        gen = torch.Generator().manual_seed(21)
        S = int(SECONDS * 16000)
        logs, updates = [], []
        _reset_counts()
        t = time.perf_counter()
        for i in range(REMAT_UPDATES):
            batch = _train_batch(REMAT_B, S, REMAT_U, caat.vocab_size,
                                 caat.eos, dev, seed=i)
            before = _counts()
            contexts.clear()
            kept.clear()
            out = step(i, batch, gen)
            after = _counts()
            logs.append({k: float(out[k]) for k in ("loss_total",
                                                    "grad_norm", "skipped")})
            updates.append(({k: after[k] - before[k] for k in after},
                            [(c.seed, c.sites, n)
                             for c, n in zip(contexts, kept)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return {"logs": logs, "params": params, "gen": gen.get_state(),
            "updates": updates, "counts": _counts(), "sets": _set_paths(),
            "peak": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "s": wall,
            "attention_dropout": w2v.attention_dropout}


def _check_remat_launches(label, policy, run, none):
    """Under ``none`` K2 == K3 == the encoder layers kept; a policy that
    recomputes the forward launches K2 twice and K3 once per kept layer,
    and K4 once more per forward K4 site (the context's sites less the
    flash layers' in-kernel dropout sites) and no more; the forward and
    the recompute take the same seed, sites and layers; the lattice walks
    run as in the plain step."""
    for (c, ctxs), (c0, ctxs0) in zip(run["updates"], none["updates"]):
        (seed, sites, kept), = ctxs0
        flash_sites = kept if run["attention_dropout"] else 0
        k2, k3, k4 = (c[n] for n in ("blockwise_flash_attention_packed",
                                     "blockwise_flash_attention_bwd",
                                     "hw_dropout"))
        if policy in ("dots", "nothing", "offload_dots"):
            assert ctxs == ctxs0 * 2, (label, ctxs, ctxs0)
            assert k2 == 2 * kept and k3 == kept, (label, c, kept)
            assert k4 == c0["hw_dropout"] + sites - flash_sites, (
                label, k4, c0["hw_dropout"], sites, flash_sites)
        else:
            assert ctxs == ctxs0, (label, ctxs, ctxs0)
            assert k2 == k3 == kept and k4 == c0["hw_dropout"], (label, c)
        # the loss's forward walk saves nothing for the backward (its
        # backward walks again), so the recompute stops before it
        # (checkpoint's early stop): the walks are the plain step's
        for walk in WALKS:
            assert c[walk] == c0[walk] > 0, (label, walk, c, c0)


def phase_remat_parity(card):
    """21a: the CAAT Large widths (1024, 16 heads, FFN 4096) cut to 4
    encoder and 2 + 2 decoder and jointer layers, bf16, flash, the
    recipe's dropouts, B 4 x 10 s, U 40, 3 updates through make_train_step
    under each run of REMAT_RUNS; each against its reference run: losses
    within rtol 1e-5, grad norms within 1e-4, every parameter within 1e-2
    x lr, the same skips, the update generator in the same state; the
    launch counts of ``_check_launches``.  -> {path: launch counts}."""
    import torch

    runs, paths = {}, {}
    for label, policy, extractor, optimizer, flat, ref in REMAT_RUNS:
        run = _remat_run(label, policy, extractor, optimizer, flat)
        c = run["counts"]
        line = (f"phase remat parity: {label} (run.remat={policy}, "
                f"remat_extractor={extractor}, {optimizer}, flat={flat}): "
                f"losses {[round(x['loss_total'], 3) for x in run['logs']]}"
                f", grad norms {[round(x['grad_norm'], 4) for x in run['logs']]}"
                f"; per update K2/K3/K4/walks "
                f"{[(u['blockwise_flash_attention_packed'], u['blockwise_flash_attention_bwd'], u['hw_dropout'], u['transducer_forward_walk'], u['transducer_reverse_walk']) for u, _ in run['updates']]}"
                f", (seed, sites, layers kept) of each context "
                f"{[[x[1:] for x in ctx] for _, ctx in run['updates']]}; "
                f"peak {run['peak']:.3f} GB above the run's start, "
                f"{REMAT_UPDATES} updates "
                f"{run['s']:.2f} s")
        if ref is not None:
            want = runs[ref]
            loss = max(abs(a["loss_total"] - b["loss_total"])
                       / abs(b["loss_total"])
                       for a, b in zip(run["logs"], want["logs"]))
            gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                        for a, b in zip(run["logs"], want["logs"]))
            pmax = max((p - want["params"][k]).abs().max().item()
                       for k, p in run["params"].items())
            line += (f"; against {ref}: loss max rel diff {loss:.3g}, grad "
                     f"norm {gnorm:.3g}, params max |diff| {pmax:.3g} (lr "
                     f"{REMAT_LR:g}), generator state equal "
                     f"{torch.equal(run['gen'], want['gen'])}")
            assert [x["skipped"] for x in run["logs"]] == [
                x["skipped"] for x in want["logs"]], label
            assert loss <= REMAT_TOL["loss_rtol"], (label, loss)
            assert gnorm <= REMAT_TOL["grad_norm_rtol"], (label, gnorm)
            assert pmax <= REMAT_TOL["param_over_lr"] * REMAT_LR, (label,
                                                                   pmax)
            assert torch.equal(run["gen"], want["gen"]), label
        print(line + f" [{card}]")
        assert all(x["skipped"] == 0.0 for x in run["logs"]), label
        if flat != "raveled":
            _check_remat_launches(label, policy, run, runs.get("none", run))
            kept = sum(ctx[0][2] for _, ctx in run["updates"])
            _on_tensor_cores(run["sets"], {
                "K1": 0, "K3": kept,
                "K2": c["blockwise_flash_attention_packed"]})
        paths[f"remat {label}"] = c
        runs[label] = run
        for other in [k for k in runs if k not in (
                "none", "adafactor raveled")]:
            runs[other] = None        # only the references are kept
        torch.cuda.empty_cache()
    return paths


def _large_corpus(root):
    """21b-c's files: ``LARGE_CLIPS`` seeded-noise wavs of 10 s (S2T tsv,
    20-word transcripts) and the 10000-entry word dict -> tsv."""
    _asr_dicts(root)
    return _asr_corpus(root, "large", LARGE_CLIPS, SECONDS, 21)[1]


def phase_large_recipe(card, root, train):
    """21b: the training entry point on caat_simulasr_large.yaml at full
    depth and width (24 x 1024 encoder, 12 + 12 x 1024 decoder and
    jointer), data.max_tokens 1440000 (9 x 10 s; update_freq 2 takes 8
    rows in 2 microbatches of 4), bf16, flash, the recipe's dropouts and
    freeze schedule, seeded weights and noise, the word tokenizer, 2
    updates per call, one call per LARGE_CALLS; the final checkpoint (8
    GB of weights and moments) is not written.  -> {path: launch
    counts}."""
    import math
    from unittest import mock

    import torch
    from wav2vec_s_tpu_torch.checkpoint import io as ckpt_io
    from wav2vec_s_tpu_torch.train import cli

    class NoSave(ckpt_io.CheckpointManager):
        def save(self, *args, **kwargs):
            pass

    S = int(SECONDS * 16000)
    paths = {}
    for tag, extra in LARGE_CALLS:
        torch.cuda.empty_cache()
        argv = ["--config", LARGE_CAAT, "--device", "cuda",
                f"data.train_manifest={train}", f"data.vocab={root}/words.txt",
                "data.tokenizer=word", f"data.max_tokens={LARGE_MAX_TOKENS}",
                f"data.max_sample_size={S}", "run.w2v2_model_path=",
                "run.max_update=2", "run.log_interval=1",
                "run.save_interval_updates=0", "run.keep_last=1",
                f"run.save_dir={root}/{tag.replace('+', '_')}",
                "model.attention_impl=flash", *extra]
        t = time.perf_counter()
        with mock.patch.object(cli, "CheckpointManager", NoSave):
            counts, sets, recs, kept, peak = _run_asr_cli(argv, set())
        wall = time.perf_counter() - t
        assert [r["step"] for r in recs] == [1, 2] and all(
            math.isfinite(r["loss_total"]) and r["skipped"] == 0.0
            for r in recs), (tag, recs)
        k2, k3 = (counts["blockwise_flash_attention_packed"],
                  counts["blockwise_flash_attention_bwd"])
        recompute = any(x.startswith("run.remat=") for x in extra)
        if recompute:        # kept counts the forward's and the recompute's
            assert k2 == sum(kept) == 2 * k3 > 0, (tag, counts, kept)
        else:
            assert k2 == k3 == sum(kept) > 0, (tag, counts, kept)
        _on_tensor_cores(sets, {"K1": 0, "K2": k2, "K3": k3})
        print(f"phase large recipe: {tag}: configs/caat_simulasr_large.yaml"
              f" {' '.join(extra) or '(no switch)'}, full depth and width, "
              f"bf16, flash, B 8 of 9 x {SECONDS:g} s in 2 microbatches of "
              f"4: peak memory {peak:.3f} GB; second update "
              f"{recs[1]['at'] - recs[0]['at']:.3f} s (the first, with the "
              f"warm-up, {recs[0]['at'] - t:.1f} s after the call's start); "
              f"losses {[round(r['loss_total'], 2) for r in recs]}; launches "
              f"K2 {k2} K3 {k3} K4 {counts['hw_dropout']} walks "
              f"{counts['transducer_forward_walk']} / "
              f"{counts['transducer_reverse_walk']}; the whole call "
              f"{wall:.1f} s [{card}]")
        paths[f"large {tag}"] = counts
    torch.cuda.empty_cache()
    return paths


def _optimizer_ms(card):
    """21b: the optimizer's update alone over the parameters of
    caat_simulasr_large.yaml at full depth (shapes from a model on the
    meta device, seeded values on the card): Adam over one tensor per
    parameter (the tree) against Adam over the flat vector
    (``FlatParams``), device ms between CUDA events and host ms per
    update, in turns (tree, flat, flat, tree).  -> {kind: best ms}."""
    import math

    import torch
    from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
    from wav2vec_s_tpu_torch.train import cli, config
    from wav2vec_s_tpu_torch.train.optim import Adam, OptimConfig
    from wav2vec_s_tpu_torch.train.step import FlatParams

    w2v, caat = cli.caat_configs(config.load_config(LARGE_CAAT, []), 10000)
    with torch.device("meta"):
        shapes = [p.shape for p in W2V2CaatModel(w2v, caat).parameters()]
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    opt = Adam(OptimConfig(lr=1e-4, clip_norm=25.0,
                           lr_scheduler="polynomial_decay",
                           warmup_updates=0, total_updates=100))
    sides = {}
    for kind in ("tree", "flat"):
        params = [torch.randn(s, device="cuda", generator=g) * 0.02
                  for s in shapes]
        grads = [torch.randn(s, device="cuda", generator=g) * 1e-3
                 for s in shapes]
        if kind == "flat":
            flat = FlatParams(params)
            flat.grad.copy_(torch.cat([t.reshape(-1) for t in grads]
                                      + [flat.grad.new_zeros(
                                          flat.grad.numel() - flat.size)]))
            params, grads = [flat.param], [flat.grad]
        state = opt.init(params)
        gnorm = torch.tensor(1.0, device="cuda")
        sides[kind] = lambda p=params, gr=grads, st=state: opt.update(
            p, gr, st, gnorm)
    ms = {"tree": [], "flat": []}
    host = {"tree": [], "flat": []}
    for kind in ("tree", "flat", "flat", "tree"):
        ms[kind].append(_cuda_ms(sides[kind], 5))
        host[kind].append(_host_ms(sides[kind], 1, reps=3))
    n = sum(math.prod(s) for s in shapes)
    print(f"phase large recipe: Adam's update alone over the recipe's "
          f"{len(shapes)} parameters ({n} values, full depth): tree "
          f"{['%.3f' % x for x in ms['tree']]} ms device, "
          f"{['%.3f' % x for x in host['tree']]} ms host; flat "
          f"{['%.3f' % x for x in ms['flat']]} ms device, "
          f"{['%.3f' % x for x in host['flat']]} ms host [{card}]")
    del sides
    torch.cuda.empty_cache()
    return {k: min(v) for k, v in ms.items()}


def phase_native_reader(card, root, train):
    """21c: 9 PCM16 wavs of 10 s, a stereo one and one at 8 kHz: the
    native batched reader equals the per-file reader row for row, bit for
    bit (stereo: 2 channels, exact in both); the 8 kHz file raises at 16
    kHz and reads equal without a rate; then the Large batch's collate
    (CaatBatcher of caat_simulasr_large.yaml, normalize, 9 x 10 s) with the
    native reader against the per-file twin, in turns.  -> {reader: host
    ms per collate}."""
    from unittest import mock

    from wav2vec_s_tpu_torch import native
    from wav2vec_s_tpu_torch.data import audio, dataset
    from wav2vec_s_tpu_torch.train import cli, config

    t = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(22)
    S = int(SECONDS * 16000)
    pcm = rng.integers(-32768, 32768, (2, S)).astype("<i2")
    stereo = root / "stereo.wav"
    import wave
    for path, rate, ch, data in ((stereo, 16000, 2, pcm.T), (
            root / "rate8k.wav", 8000, 1, pcm[0, :8000])):
        with wave.open(str(path), "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(np.ascontiguousarray(data).tobytes())
    from wav2vec_s_tpu_torch.data.manifests import read_s2t_manifest
    man = read_s2t_manifest(train, "")
    paths = [man.audio_paths[i] for i in range(9)] + [str(stereo)]
    got = audio.read_audio_batch(paths, S)
    for p, row in zip(paths, got):
        assert np.array_equal(row, audio.read_audio(p)), p
    try:
        audio.read_audio_batch([paths[0], str(root / "rate8k.wav")], S)
        raise AssertionError("a file of 8 kHz read at 16 kHz")
    except ValueError as e:
        assert "sample rate 8000 != 16000" in str(e), e
    eight = audio.read_audio_batch([str(root / "rate8k.wav")], S, None)[0]
    assert np.array_equal(eight, audio.read_audio(root / "rate8k.wav",
                                                  None))
    cfg = config.load_config(LARGE_CAAT, [
        f"data.train_manifest={train}", f"data.vocab={root}/words.txt",
        "data.tokenizer=word", f"data.max_sample_size={S}"])
    batcher = cli._s2t_data(cfg)[2]

    def per_file(paths, stride, expected_rate=16000):
        return [audio.read_audio(p, expected_rate) for p in paths]

    def collate_ms(twin):
        with mock.patch.object(dataset, "read_audio_batch",
                               per_file if twin else audio.read_audio_batch):
            t = time.perf_counter()
            out = batcher.collate(np.arange(9))
            return (time.perf_counter() - t) * 1e3, out

    ms = {"native": [], "per-file": []}
    outs = {}
    for i in range(READER_REPS):
        for twin in ((False, True) if i % 2 == 0 else (True, False)):
            t_ms, outs[twin] = collate_ms(twin)
            ms["per-file" if twin else "native"].append(t_ms)
    for k in outs[False]:
        assert np.array_equal(outs[False][k], outs[True][k]), k
    best = {k: min(v) for k, v in ms.items()}
    print(f"phase native reader: read_audio_batch == read_audio on 9 mono "
          f"PCM16 wavs of {SECONDS:g} s and a stereo one, bit for bit; an 8 "
          f"kHz file raises at 16 kHz and reads equal without a rate; the "
          f"library built in {build_s:.2f} s (g++, cached after); the Large "
          f"batch's collate (9 x {SECONDS:g} s, normalize) ms per call, "
          f"native {['%.2f' % x for x in ms['native']]} (best "
          f"{best['native']:.2f}), per-file "
          f"{['%.2f' % x for x in ms['per-file']]} (best "
          f"{best['per-file']:.2f}), the same batch [{card}]")
    return best


def phase_remat_flat_reader(card):
    """21: 21a, then 21b and 21c on one corpus."""
    import pathlib
    import tempfile

    paths = phase_remat_parity(card)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train = _large_corpus(root)
        collate = phase_native_reader(card, root, train)
        paths.update(phase_large_recipe(card, root, train))
    _optimizer_ms(card)
    print(f"phase large recipe: host ms per collate of the Large batch "
          f"(phase 21c): {collate} [{card}]")
    return paths


def _check_launches(path, counts, sets, want, k2_per_call=None):
    """K1 and K2 launches of a path == ``want``, all on the tensor-core
    kernels, no K3; with ``k2_per_call`` K2 must be a positive multiple of
    it instead (a count that depends on the run)."""
    if k2_per_call:
        k2 = counts["blockwise_flash_attention_packed"]
        assert k2 > 0 and k2 % k2_per_call == 0, (path, counts)
        want = dict(want, K2=k2)
    assert counts["chunk_cache_attention"] == want["K1"], (path, counts)
    assert counts["blockwise_flash_attention_packed"] == want["K2"], (
        path, counts)
    _on_tensor_cores(sets, dict(want, K3=0))


def _clocked(phase, *args):
    """``phase(*args)``, then its wall seconds on a line of their own."""
    t = time.perf_counter()
    out = phase(*args)
    print(f"phase clock: {phase.__name__}: {time.perf_counter() - t:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wav2vec_s_tpu_torch.ops import native

    # float32 references in full precision (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--cli-parallel-rank"]:    # phase 16b's rank
        return _cli_parallel_rank(sys.argv[2])
    card = _card()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, cuda {torch.version.cuda})")

    t = start = time.perf_counter()
    native.library()
    print(f"phase build: {time.perf_counter() - t:.1f} s "
          f"(nvcc {native.build_seconds and round(native.build_seconds, 1)} s)"
          f"; ptxas (kernel<template arguments>: registers, bytes spilled): "
          + "; ".join(f"{name}: {regs}, {spilled}" for name, regs, spilled
                      in native.ptxas_summary(native.build_log)))

    k1 = _clocked(phase_kernel)
    k7 = _clocked(phase_decode_attention)
    k2 = _clocked(phase_flash)
    k3 = _clocked(phase_flash_bwd)
    pretrain_calls = _clocked(phase_flash_pretrain)
    k4 = _clocked(phase_dropout)
    lat = _clocked(phase_lattice)
    _clocked(phase_parity)
    _clocked(phase_oneshot_parity)
    same_in_bf16 = _clocked(phase_beam_parity)
    _clocked(phase_serving_parity)
    _clocked(phase_train_parity)
    _clocked(phase_train_flash_parity)
    _clocked(phase_pretrain_parity)
    paths = {"agent": _clocked(phase_full, card),
             "one_shot": _clocked(phase_oneshot_full, card)}
    paths.update(_clocked(phase_beam_full, card, same_in_bf16))
    (paths["train_dense"], paths["train_long"], dense_ups,
     dense_gb) = _clocked(phase_train_full, card)
    paths["cli_flash"] = _clocked(phase_cli_full, card)
    paths.update(_clocked(phase_eval_cli_full, card))
    paths["serving"] = _clocked(phase_serving_full, card)
    paths.update(_clocked(phase_pretrain_full, card))
    ddp_counts, ddp_one, ddp_split = _clocked(phase_ddp, card)
    for name, counts in ddp_counts.items():
        paths["ddp " + name] = counts
    _clocked(phase_cli_parallel, card)
    _clocked(phase_asr_parity)
    asr_paths, asr_k4_err = _clocked(phase_asr_full, card)
    paths.update(asr_paths)
    _clocked(phase_family_parity)
    family_paths, family_k4_err, family_walk_errs = _clocked(
        phase_family_full, card)
    paths.update(family_paths)
    _clocked(phase_baseline_parity)
    full_paths, full_k4_err = _clocked(phase_full_context, card)
    paths.update(full_paths)
    baseline_paths, baseline_k4_err = _clocked(phase_baselines_full, card)
    paths.update(baseline_paths)
    more_paths, tp_k4_err, tp_timing = _clocked(
        phase_parallel_more, card, ddp_one, ddp_split)
    paths.update(more_paths)
    paths["prep_debug_cli"] = _clocked(phase_prep_debug, card)
    paths.update(_clocked(phase_remat_flat_reader, card))
    k4["max_abs_err"] = max(k4["max_abs_err"], asr_k4_err, family_k4_err,
                            full_k4_err, baseline_k4_err, tp_k4_err)
    for walk, err in family_walk_errs.items():
        lat[walk]["max_abs_err"] = max(lat[walk]["max_abs_err"], err)
    # K4 and the warp set's two fused walks carry both families' training
    for path in ("fbank_cli", "text_cli"):
        assert all(paths[path][name] > 0 for name in (
            "hw_dropout", *WALKS)), (path, paths[path])
    # K4 carries every new training path, K2 and K3 the flash ones
    for path in ("pretrain_from_pt", "waitk_train", "mma_train",
                 "mma_train_short", "prep_debug_cli",
                 *(p for p in paths if p.startswith(("tp ", "remat ",
                                                     "large ")))):
        assert all(paths[path][name] > 0 for name in (
            "hw_dropout", "blockwise_flash_attention_packed",
            "blockwise_flash_attention_bwd")), (path, paths[path])
    print(f"phase train full (dense, by hand, U 40): {dense_ups:.3f} "
          f"updates/s, {dense_gb:.3f} GB peak [{card}]")

    src = "wav2vec_s_tpu_torch/csrc/"
    pa = "wav2vec_s_tpu/ops/pallas_attention.py:"
    pk = "wav2vec_s_tpu/ops/transducer/pallas_kernel.py:"
    # (counter, source, TPU kernel, the path whose run gives `launches`);
    # K1, K2 and K3: the tensor-core kernels, which the full-width paths run
    # and the rows' times are of
    rows = [("chunk_cache_attention", "chunk_attention_mma.cu",
             "wav2vec_s_tpu/ops/chunk_attention.py:89", "agent", k1),
            ("blockwise_flash_attention_packed", "flash_attention_mma.cu",
             pa + "281", "one_shot", k2),
            ("blockwise_flash_attention_bwd", "flash_attention_bwd_mma.cu",
             pa + "324", "cli_flash", k3),
            ("hw_dropout", "dropout.cu", "wav2vec_s_tpu/ops/dropout.py:64",
             "train_dense", k4),
            # the fused walks (K5a + K6, K5b + K6) run the loss: the warp
            # set's up to U 256, the block set's past it; each replaces
            # its recursion's TPU kernel and K6's (the affine rows)
            ("transducer_forward_walk", "transducer_warp.cu",
             pk + "206 + " + pk + "99",
             "train_dense", lat["forward_walk"]),
            ("transducer_reverse_walk", "transducer_warp.cu",
             pk + "224 + " + pk + "99",
             "train_dense", lat["reverse_walk"]),
            ("transducer_forward_walk_block", "transducer.cu",
             pk + "206 + " + pk + "99",
             "train_long", lat["forward_walk_block"]),
            ("transducer_reverse_walk_block", "transducer.cu",
             pk + "224 + " + pk + "99",
             "train_long", lat["reverse_walk_block"]),
            # K7 replaces no TPU kernel: the JAX package's emission loop
            # left its one-query attentions to XLA
            ("decode_attention", "decode_attention.cu",
             "none (XLA: wav2vec_s_tpu/stream/caat_step.py)", "agent", k7)]
    for name, _, _, path, _ in rows:
        assert paths[path][name] > 0, (name, path, paths[path])
    # K7 carries the emission loops of the three main paths
    assert all(paths[p]["decode_attention"] > 0
               for p in ("agent", "one_shot", "serving")), paths
    # K2 and K3 at the pre-training call, per context bucket (phase 3c),
    # and at a tensor-parallel rank's call with its head base (phase 20a)
    for name, key in (("blockwise_flash_attention_packed", "K2"),
                      ("blockwise_flash_attention_bwd", "K3")):
        row = next(r for n, _, _, _, r in rows if n == name)
        ms, plain_ms, bound, library_ms = tp_timing[key]
        row["tp_call"] = {"ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "library_ms": library_ms}
        row["pretrain_call"] = {
            b: {"ms": t[f"{key}_ms"], "bound_ms": t[f"{key}_bound_ms"],
                "library_ms": t[f"{key}_library_ms"], "S": t["S"]}
            for b, t in pretrain_calls.items()}
    print(f"phase clock: the whole script {time.perf_counter() - start:.1f} "
          f"s")
    print(card)
    # K7's launches by path: the three main paths' runs (phases 9, 10 and
    # 14, graph replays counted by torch.profiler); elsewhere its wrapper
    # sees only the eager launches
    k7_paths = ("agent", "one_shot", "serving")
    kernels = [
        dict({"name": name, "route": "cuda", "source": src + file,
              "replaces": replaces, "launches": paths[path][name],
              "launches_by_path": {
                  p: c[name] for p, c in paths.items()
                  if name != "decode_attention" or p in k7_paths}},
             **row)
        for name, file, replaces, path, row in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
