#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (korean_f5_tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit; build the Hopper kernels from
     korean_f5_tts_tpu_torch/csrc and print the build time;
  2. hold each of the sixteen kernels, kernel 14's quantization pass and
     the fp32 forms of A, B, C, 7, 8, 14 and its pass, 18, 19 (what the
     offline entry points run by default, under each attn_path and
     attn_int8) and of 10-13 (what fp32 training runs; A, B, C, 7, 8,
     10-13, 18 and 19 split 3xTF32 products on the tensor cores, 14 "qk"
     exact int8 scores and a split 3xTF32 P.V, each with a TF32 control that
     must fail its bound; B, C, 7, 8 fp32 must beat their plain versions, 10
     fp32 the library's fp32 forward; C fp32 at the bf16 form's edges, the
     fp32 library composition (conv with bias, then Mish) beside it; A fp32
     beside the fp32 library attention on keys sliced to the common kv_len;
     bound of every
     fp32 form: its fp32-accurate products at the 3xTF32 rate, 494.7 / 3
     TFLOP/s, with the FFMA rate's 67 TFLOP/s printed beside) (bf16: A, B,
     C; int8: 9, 5, 6, 4;
     training: 10, 11, 12, 13, with PyTorch's flash attention forward and
     backward as the library yardsticks of 10 and of 11 + 13, 10 on the
     attention core and 11 and 13 on the attention backward core at the
     training shape, a ragged case and the tiles' edges (n 1, 63-65, 100,
     127-129, 200, 301; kv_len 0, 1, 63-65, 127-129, n; keys past kv_len at +-1e4),
     10 launched twice
     on the same inputs (the remat recompute: equal to the bit), a head with
     kv_len 0 held to zero o, lse 0 and zero dk, dv; the fp32 forms of
     10-13 at the same edges within 1e-5 (o, lse) and 1e-4 (dq, dk, dv)
     with TF32 off, a control with TF32 on that
     must fail those bounds, and PyTorch's memory-efficient attention on fp32
     (forward with its logsumexp, backward) as their yardstick, its error
     printed beside its time; C on TMA + wgmma at N 1, 15-17, 31, 127-129,
     1376, 1536, B 1-3, without bias, without Mish, for two weight draws,
     F.conv1d(groups=16) with bias (and + Mish) in bf16 timed beside it;
     the opt-in attention paths: 7, 8, 18, 19;
     A at d = 64 on the TMA + wgmma attention core at n = 1, 127, 128, 129,
     1000, 1536, mixed kv_lens with 0 (zeros) and n, H = 1 and keys past
     kv_len at +-1e4, with its TFLOP/s, share of the bound, the core at 192
     rows a block and the mma.sync loop it replaced timed beside it, and
     SDPA on keys sliced to the common kv_len under each backend (the
     library yardstick) and with a boolean mask (printed, not the
     yardstick); B, 7 and 8 on the TMA + wgmma core with their achieved
     TFLOP/s and share of the bound, 7 held to be no slower than the library
     composition it replaces; 4, 5, 6 and 9 on the int8 TMA + wgmma core
     with their TOP/s and share of the bound, at ragged rows, 1 and 3
     segments, a d that is no multiple of the 128-deep k step, and each tile
     width forced (9 at M 1, 100, 1000, 3072, 6144, K 1024, 1040, 2048, 4096,
     N 128, 384, 1024, with and without bias and GELU, exact without GELU,
     its TOP/s at M 3072 and 6144); 4, 5, 6 and 9 on fp32 rows with fp32
     vectors (6 and 9 exact), timed; 19 and 18 on the attention core's rope
     form at n 1, 127-129, 191-193, 1000, 1536, kv_len 0, 1, 127-129, n, K
     and V rows past kv_len at +-1e4, heads 2 and 16, B 1-3, against their
     plain versions, against kernel A on torch-roped inputs and against each
     other (to the bit), the default path's composition timed beside them;
     int8 attention: 14 on the attention core's int8 form, in both modes, at
     the same edges, against its plain version and its quantization error
     against kernel A on the same inputs (mean and max held in every case,
     the tail where its bound was set), and its quantization pass (one
     kernel) against its plain version to the bit, each timed with its
     bound, pass + 14 beside kernel A; C in bf16 and fp32 at every other
     group width it takes, 16, 32 and 128 channels, at the block's edges and
     timed, and at 48 (dim 768), where the wrapper refuses the shape and
     conv-pos takes the plain convolution, C's counters unmoved; A in bf16
     and fp32 at n 1537 (UNetT's time token) and 1696 (MMDiT's joint
     sequence), 10, 11, 13 in both at n 1281)
     against its plain PyTorch version at the main-path shapes, plus ragged,
     zero-row and outlier cases, and time both with CUDA events (20 runs
     after a warm-up), beside the least time the card could take for the
     same work (bytes over 3.35 TB/s or operations over the published peak,
     whichever is larger) and, for kernel A, the one PyTorch call that
     computes the same function (scaled_dot_product_attention, which no path
     of the port uses); kernels 7, 8, 18, 19 also beside the calls of the
     default path that they replace, 18 and 19 also against kernel A on
     torch-roped inputs; the training attention's autograd Function against
     autograd of the plain attention; scripts/probe_hopper.py (the rope
     idioms and the TMA, mbarrier and wgmma idioms of the product cores and
     of the attention cores, among them the strided 4-D map over the fused
     qkv rows and the rotation in shared memory before a wgmma);
  3. build F5TTS_v1_Base + Vocos with seeded random weights (AdaLN-zero
     layers re-drawn), in bf16 and again with int8 weights
     (load_model(..., quantize=True)); for each mode serve three HTTP /tts
     requests through the port's serve() (one alone, then two concurrently
     as one batch of 2), check the audio and that every kernel's launch
     count, reset just before, is exactly what the mode's path requires;
  4. for each mode run the bench protocol (cond 432, total 1376, bucket
     1536, 16 NFE, CFG 2, sway -1, batch 1) through the sampler with kernels
     and with the plain versions, and compare the mels;
  5. for each mode time the port's RTF at that protocol (1 warm-up, 10
     timed runs);
  6. train F5TTS_v1_Base (full width, depth 22, fp32 masters, bf16 compute,
     conv-pos convolving in bf16 under autograd,
     activation checkpointing, AdaLN-zero layers re-drawn): one step's loss
     and whole gradient with kernels against the plain versions, with the
     exact launch counts of a step; the attention backward's own entry point
     (flash_prefix_attention_bwd without a forward lse: kernels A, 12, 13)
     on bf16 and on fp32 operands; the fp32 step (compute_dtype None, the
     default of train_step and the Trainer): its loss and whole gradient with
     the fp32 forms against the plain versions at depth 22 (exact launch
     counts, bound 1e-4), and at depth 2 against the same step on the CPU
     with the same draws, for three weight and draw seeds (bound 1e-4; the
     card with PyTorch's own TF32 defaults, conv-pos convolving in TF32,
     and with cuDNN's TF32 off printed beside it);
     Trainer.train on an in-memory dataset of seeded mels packed to 8 x 1280
     frames, 2 updates, a checkpoint, a resume and 2 more (launches counted
     over all 4), in bf16 compute and again with the Trainer's own default
     (fp32), at full width and a depth of 4 blocks (at depth 22 the
     5 GiB checkpoint, written twice and read once, took 98 of the script's
     262 s on an H100); then bench_train's protocol at batch 8 x 1280 (1 warm-up + 8
     steps) with kernels and plain in bf16 and with kernels in fp32, at
     depth 22; one bf16 and one fp32 step's device busy time under the
     profiler;
  7. bf16, for each opt-in attention path (attn_path "linear_fused":
     kernels 7, A, 8; "rope_in_kernel": kernel 18; "qkv_kernel": kernel 19):
     serve one HTTP request alone and two as a batch with exact launch
     counts, compare the bench-protocol mel with the same path's plain
     versions (and print its distance to the default path's), and time the
     RTF beside the default path's;
  8. the offline entry point at full width: api.F5TTS(device="cuda").infer
     on a chirp reference and a text of three or more unequal chunks, under
     "default" and "qkv_kernel" and once without CFG (cfg_strength 0), with
     the wav's length, finiteness, loudness and the exact launch counts
     checked; F5TTS(device="cuda") with its own defaults (fp32 weights): the
     fp32 forms of A, B, C with exact launch counts and the bf16 counters
     unmoved, its mel against the same path's plain versions, against the
     bf16 path, with cuDNN's TF32 convolutions on (PyTorch's default) and
     off, and against an fp32 run on the CPU at depth 2;
     F5TTS(device="cuda", quantize=True) with its default fp32 weights (int8
     weights on fp32 rows: kernels 5, 6, 4 and the fp32 forms of A and C,
     exact launch counts), its mel against the same path's plain versions
     (bound 5e-2), cfm_sample on a batch of 2 under a duration mask (kernel
     9 for the projections), and the server's --compute_dtype float32
     --quantize arguments serving one request; F5TTS(device="cuda") with its
     default fp32 weights under linear_fused, rope_in_kernel, qkv_kernel,
     attn_int8 "qk" and "qkpv", and quantize=True with "qk" (the fp32 forms
     of 7, 8, 18, 19, 14 and its pass, exact launch counts, the mel against
     the same path's plain versions: 1e-4, int8 attention 5e-2) and the
     server's --compute_dtype float32 --attn_path qkv_kernel serving one
     request; then cfm_sample on a
     batch of 3 whose durations fall into two
     buckets, under "rope_in_kernel" and "qkv_kernel": two groups run, the
     group of 2 under a duration mask, each item equals the same item
     sampled alone, and the counts are exact;
  9. int8 attention (attn_int8) and the rest of serving and inference, at
     full width with int8 weights: (a) warm_start, then serve() with
     attn_int8 "qkpv": three HTTP requests with exact launch counts (kernel
     14 and its quantization pass in kernel A's place); (b) the
     bench-protocol mel with kernels against the plain versions, the RTF
     and the mel MAE against the bf16 sampler for
     "qk" and "qkpv" over bf16 and over int8 weights, beside the int8
     default; (c) a TTSService with a plain callable vocoder: one request
     through _synthesize, two through _synthesize_batch, each against the
     fused path's audio for the same request; (d) the gRPC handler bodies on
     proto3 bytes (no grpc import) and one socket-server round trip on
     localhost; (e) run_latency_benchmark and run_offline_benchmark at 3
     items, with and without int8 attention, their JSON on a line each (a
     check that they run: percentiles of 3 requests are no distribution, the
     module's own command line measures 26); (f)
     edit_speech with one edit span (the kept frames are the input mel) and
     batch_generate of two rows;
 10. fine-tuning a checkpoint, fp32 (run before phase 6, whose profiler slows
     every later launch; its own profile runs after phase 6): (a) seeded
     F5TTS_v1_Base weights as a reference-format .pt (torch.save, the
     ema_model. prefix, q/k in the interleaved rope layout) and as a .npz:
     load_model's tensors from the .pt equal the .npz route's and the
     source's to the bit, the bench-protocol mel of the two routes max abs
     0, one F5TTS(ckpt_file=.pt).infer call of one chunk (length, finite,
     exact launches of A, B, C fp32); (b) a seeded Vocos state dict through
     scripts/convert_vocoder.py and load_vocoder(local_path=): the decode
     equals the source params' (max abs 0); (c) vocab_extend with 8 new
     tokens on (a)'s .npz, then train_lora's loop on the F5TTS_Base recipe
     arch (no remat, pe_attn_head 1) over seeded mels at the recipe's
     9,600-frame budget, 4 updates: finite losses, base tensors equal to the
     bit after training, every adapter's a, b and scale moved, exactly 22
     launches a update of 10, 11, 13 fp32 and none of any other counter, the
     peak memory; 3 more updates timed alone; the merged .npz back through
     load_model and one bench-protocol utterance; after phase 6, one
     update's device busy time; (d) Trainer(grad_accumulation_steps=2) at
     depth 4, fp32, full remat: Trainer.train's loop written out (its step,
     batches and seeds) moves the weights at mini-steps 2 and 4 only
     (gradient_step and schedule count 2); Trainer.train for 3, a resume,
     1 more ends within rel 1e-6 of it; exact launches.
 11. the other backbones, at full width on seeded weights (AdaLN-zero layers
     re-drawn), on the bench protocol (cond 432, total 1376, bucket 1536,
     160 text tokens, CFG 2, sway -1, EPSS, 16 steps), each utterance with
     exact launch counts and its mel against the plain versions (relative L2
     over the valid rows, 5e-2), run before phase 6: (a) E2TTS_Base (UNetT)
     through F5TTS(model="E2TTS_Base") in bf16 (A 384, C 32 an utterance),
     its RTF and device time, and three HTTP requests through serve(); (b) a
     reference-format UNetT .pt written by unett_state_dict and an .npz of
     the same seeded weights through load_model(ckpt_path=): equal to the
     bit; (c) one UNetT training step at 8 x 1280 frames in fp32 and in bf16
     compute: loss and whole gradient with kernels against plain (1e-4,
     5e-2), exactly one launch of 10, 11 and 13 a block (no remat); (d) an
     MMDiT at MMDiTConfig()'s widths: bf16 sampling (A 352 on the text-first
     joint sequence of 1696, C 32) and the training step of (c); (e)
     F5TTS_v1_Base with qk_norm "rms_norm" on the default path, under
     "linear_fused" and with int8 weights: A, B (or 4 and 9) as usual, 5, 6,
     7 and 8 never; (f) F5TTS_Small and E2TTS_Small (48 channels a conv-pos
     group): C 0, A 288 and 320, with RTFs; (g) BigVGAN at its default config
     decoding a 1376-frame mel (finite, 1376 x 256 samples, timed) and a
     24-frame mel against the CPU in fp32 (1e-4). The training steps and the
     checkpoint of (b)-(d) are cut to a depth of 8 blocks: the plain fp32
     step at 8 x 1280 materialises every block's [128, 1281, 1281] scores.
 12. parallelism and the rest of training, F5TTS_v1_Base at full width, run
     before phase 6: two processes of this script (--phase12-rank) form a
     process group over gloo with CUDA tensors on the one card (NCCL refuses
     two ranks on one device): (a) tensor parallel 2 serving on the bench
     protocol in bf16 on the default path and on "linear_fused" and with
     int8 weights, each rank's launches exact (A, B 352, C 32; 7, 8 352;
     5, 6, 4, A 352), the ranks' mels equal, the mel against one process
     (5e-2); (b) one training step at 8 x 1280 (data parallel: 2 x 4 rows;
     tensor parallel: 8 heads and 1024 FF columns a rank), bf16 and fp32,
     loss and whole gradient against one process (5e-2, 1e-4), 10, 11, 13
     per rank exact; (d) the tensor-parallel train state written as a
     sharded checkpoint and read back to the bit, its size and times; (e)
     tensor parallel 2 sampling of E2TTS_Base (UNetT, 24 blocks) and of an
     MMDiT at MMDiTConfig()'s widths (22 blocks) on the bench protocol in
     bf16, the MMDiT also under attn_int8 "qkpv", each rank's launches exact
     (E2TTS_Base A 384, C 32; MMDiT A 352 on the text-first joint sequence,
     C 32; 14 and its pass in A's place), the mel against one process
     (5e-2); (f) the step of (b) for each of the two at 8 blocks, no remat
     (10, 11, 13 8 a rank), bf16 and fp32; (g) the MMDiT's tensor-parallel
     train state (to_q_c, to_out_c, ff_c among its leaves) as the sharded
     checkpoint of (d); then in this process (c) make_mesh(1, 1) on NCCL at
     world size 1, and (h) training steps through 7 and 8 ("linear_fused"),
     18 and 19 under autograd against the plain versions, bf16 and fp32,
     exact launches, and remat "dots" against "full" (gradient, step ms,
     peak GiB). Phase 12's training steps and checkpoints are cut to 8
     blocks. Two ranks sharing one card measure correctness and launches,
     not a tensor-parallel speed.
     Phase 2 also holds A, B, 4-8, 10, 11, 13 and 14 at the tp 2 and tp 4
     shard shapes.
 13. head dim 128 and 8 channels a conv-pos group, run before phase 6 (phase
     2's check_head_dim128 holds every d = 128 form of A, 10-13, 18, 14 in
     its four forms and its pass, bf16 and fp32, and C at 8 channels, at
     their main shapes and edges, each timed beside its bound, plain version
     and library call; A, 10 and 18 in bf16 on the attention core beside
     the mma.sync loop it replaced, 13 in bf16 on the backward core beside
     the mma.sync kernel it replaced, A, 10, 18 and 11-13 in fp32 on split
     3xTF32 beside the FFMA kernels they replaced, in one process, and at
     each new kernel's tile edges): (b) F5TTS_v1_Base's widths with 8 heads of 128,
     depth 22, seeded weights, the bench protocol on every attn_path (19
     steps aside: A 352), under attn_int8 "qk" and "qkpv", with int8
     weights, and one fp32 chunk per attn_path and per attn_int8 mode, each
     with exact launches and its mel against the plain versions (5e-2;
     fp32 1e-4); (c) bf16 and fp32 training steps at 8 x 1280, 8 blocks,
     full remat (10 16, 11 8, 13 8), a "dots" step, and the backward's own
     entry point (A, 12, 13); (d) a DiT of dim 128 (1 head of 128: C at 8
     channels a group) in bf16 and fp32; (e) a DiT of dim_head 96 on every
     attn_path and attn_int8 mode: no attention kernel launches, sdpa equal
     to the plain bf16 attention.
 14. the evaluation harness and the measuring scripts, run before phase 6:
     (a) ECAPA-TDNN at EcapaConfig()'s widths (80 features, 512 channels,
     192 dims) on 3 s of noisy 24 kHz audio resampled to 16 kHz: the card's
     fp32 embedding within rel 1e-4 of the CPU's with cuDNN's process-wide
     TF32 switch on (the encoder turns it off for its own call and restores
     it), the TF32 control printed beside it and required to fail the
     bound; (b) eval.evaluate_korean.evaluate_one_model on F5TTS_v1_Base
     (bf16, a kor_grapheme vocabulary) for 2 Korean rows at nfe_step 32 with
     an echo transcriber (CER and WER 0) and ECAPA's embed_fn (SIM), the
     summary printed, A, B 22 x 32 and C 2 x 32 launches a chunk exactly, a
     second call adding no row and launching nothing; (d)
     get_inference_prompt and synthesize_bucket on 3 prompts of mixed
     duration in one bucket, two duration groups (one of two items): each
     item's mel against the same item run alone (5e-2), launches per group
     exact; (c) evaluate_korean.main over kor_grapheme and kor_allophone at
     one checkpoint each, .npz files of seeded F5TTS_Base weights at each
     mode's vocabulary size (fp32, as main loads them: the fp32 forms of A,
     B, C, exact); (e) bench_serving_throughput (concurrency 1 and 2, 4
     requests, 10 s generated), bench_mixed_batch (batch 4, 2 iterations,
     bf16 and --int8), profile_serving_request (2 repetitions) and
     bench_grpc_live on its in-process client (n 4), each through its main
     on the card, each printing its JSON line(s), each required to launch
     its path's kernels.
 15. the fine-tuning studio and the inference UI, run before phase 6, in a
     temporary working directory: (a) a 29.4 s noisy 24 kHz recording with
     four pauses sliced by FinetuneProject.slice_audio (five clips),
     transcribed by an injected function (fixed Korean sentences),
     prepare_arrow (kor_grapheme) and vocab_check ("You can train using
     your language !"), calculate_train for the card's memory printed; (b)
     start_training: a finetune_cli child on the card from a seeded
     F5TTS_v1_Base .npz (params and EMA) for 2 updates of up to 3,000
     frames (fp32, full depth), its JSON report held to device cuda and
     exactly the launches of 2 updates (10, 11, 13 fp32, 22 each an update:
     the preset trains without remat), its wall time and peak memory beside
     calculate_train's suggestion; a second child stopped by stop_training,
     no process of its session left; (c) the studio's Prune tab (through
     utils/gradio_stub.py) on the child's model_last.npz: only the EMA
     weights, equal to the source's; (d) test_model_infer on the pruned
     file at 16 NFE, exact launches, its wav against kernels=False within
     1e-4; (e) infer_gradio.build_app on the pruned file under the stub:
     Basic TTS, Multi-Speech-Type with two voices (each segment equal to
     infer_process of it alone with the seed the cherry-pick lines report)
     and a voice-chat turn with an injected chat backend, exact launches
     each; (f) socket_client.request_tts against the port's socket server
     on the same model: the samples equal what the server streamed, exact
     launches.
 16. the flagship parity protocol (scripts/flagship_parity.py), run before
     phase 6, at F5TTS_Base's width and depth (dim 1024, 22 blocks, 16 x 64
     heads, text_mask_padding False, pe_attn_head 1): (a) its modes card
     and card_int8attn on seeded weights (AdaLN-zero re-drawn): one
     utterance each of fp32 weights (the fp32 forms of A, B, C), bf16 (A,
     B, C), int8 weights (5, A, 6, 4, C) and int8 weights under attn_int8
     "qkpv" and "qk" (14 and its pass in A's place) from one noise draw at
     n 1536, cond 432, 16 NFE, CFG 2, sway -1, EPSS; (b) trained_flagship
     cut to 60 steps at 8 x 1280 frames (bf16 compute, remat "dots": 10, 11
     and 13 once a block and step), its checkpoint written to a temporary
     directory, then the same five utterances on the trained weights. Every
     utterance's and every step's launches exact, every mel finite, each
     fast mode within relative L2 5e-2 of fp32, the last loss below the
     first, the gates' mean |w| above 0; the protocol's MAE and rel printed
     beside them.
Serving, the training steps, bench_train, offline inference and the LoRA
run go the full depth of 22 blocks; only the Trainer runs of phases 6 and
10(d) are cut to 4 and the fp32 step against the CPU to 2 (nothing else was
cut when phases 9, 10 and 6's fp32 path were added). The line before the
last is a JSON object with the kernels' numbers (launches: the serving runs
of phases 3, 7 and 9(a), the backward entry point, the Trainer's 4 updates,
phase 8, phase 10, phase 14 (b)-(d), phase 15, the child's reported
launches among them, and phase 16); the last line is {"ok": true,
"device": {...}}.

    python3 chip_smoke.py --ab PARENT

instead times kernels A, B, C, 7, 8, 4, 5, 6, 9, 14 (both modes, each with
its quantization pass, through flash_prefix_attention_i8), 18, 19, the fp32
forms of A, B, C, 7, 8, 14 (both modes), 18, 19 and, at the training shape,
10, 11, 12 and 13 in bf16 and fp32 of the
checkout at PARENT (for example the parent commit unpacked by `git archive`)
and of this one under one timer, in turns parent, change, change, parent,
with the library yardsticks in each turn (A's: SDPA on keys sliced to the
common kv_len, under each backend; 10's and 11 + 13's: PyTorch's flash
attention forward and backward; A fp32's, 10 fp32's and 11 + 13 fp32's: its
efficient attention on fp32, on sliced keys, forward with its logsumexp,
backward; a form the parent lacks is printed as absent), and fails if any
of them is more than 5% slower than the parent's.

It needs a CUDA card and the repository checkout it sits in; it imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPLACES = {
    "flash_prefix": "korean_f5_tts_tpu/ops/flash_prefix.py:558",
    "ff_block": "korean_f5_tts_tpu/ops/ff_block.py:40",
    "grouped_conv": "korean_f5_tts_tpu/ops/grouped_conv.py:69",
    "ff_block_int8": "korean_f5_tts_tpu/ops/ff_block.py:101",
    "ln_mod_matmul_int8": "korean_f5_tts_tpu/ops/fused_linears.py:109",
    "proj_gated_residual_int8": "korean_f5_tts_tpu/ops/fused_linears.py:156",
    "qmatmul": "korean_f5_tts_tpu/ops/qmatmul.py:24",
    "flash_prefix_lse": "korean_f5_tts_tpu/ops/flash_prefix.py:612",
    "flash_prefix_dq_lsein": "korean_f5_tts_tpu/ops/flash_prefix.py:1033",
    "flash_prefix_dq": "korean_f5_tts_tpu/ops/flash_prefix.py:978",
    "flash_prefix_dkv": "korean_f5_tts_tpu/ops/flash_prefix.py:1151",
    "ln_mod_matmul": "korean_f5_tts_tpu/ops/fused_linears.py:34",
    "proj_gated_residual": "korean_f5_tts_tpu/ops/fused_linears.py:198",
    "flash_prefix_rope": "korean_f5_tts_tpu/ops/flash_prefix.py:1424",
    "flash_prefix_qkv": "korean_f5_tts_tpu/ops/flash_prefix.py:1550",
    "flash_prefix_i8": "korean_f5_tts_tpu/ops/flash_prefix.py:889",
    # kernel 14's quantization pass: XLA in the JAX package (_quant_head, the
    # scales in flash_prefix_attention_i8)
    "flash_prefix_i8_quant": "korean_f5_tts_tpu/ops/flash_prefix.py:901",
    "flash_prefix_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:558",
    "ff_block_f32": "korean_f5_tts_tpu/ops/ff_block.py:40",
    "grouped_conv_f32": "korean_f5_tts_tpu/ops/grouped_conv.py:69",
    "flash_prefix_lse_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:612",
    "flash_prefix_dq_lsein_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:1033",
    "flash_prefix_dq_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:978",
    "flash_prefix_dkv_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:1151",
    "ln_mod_matmul_f32": "korean_f5_tts_tpu/ops/fused_linears.py:34",
    "proj_gated_residual_f32": "korean_f5_tts_tpu/ops/fused_linears.py:198",
    "flash_prefix_rope_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:1424",
    "flash_prefix_qkv_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:1550",
    "flash_prefix_i8_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:889",
    "flash_prefix_i8_qk_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:889",
    "flash_prefix_i8_quant_f32": "korean_f5_tts_tpu/ops/flash_prefix.py:901",
    # the forms at head dim 128 (the JAX dispatch's d in (64, 128)) and kernel C at 8
    # channels a group (the TPU kernel's block-diagonal packing, grouped_conv.py:53-64)
    **{f"flash_prefix{f}_d128": "korean_f5_tts_tpu/ops/flash_prefix.py:770" for f in ("", "_f32")},
    **{f"{base}{f}_d128": f"korean_f5_tts_tpu/ops/flash_prefix.py:{line}"
       for base, line in (("flash_prefix_lse", 612), ("flash_prefix_dq_lsein", 1033),
                          ("flash_prefix_dq", 978), ("flash_prefix_dkv", 1151),
                          ("flash_prefix_rope", 1424), ("flash_prefix_i8", 889),
                          ("flash_prefix_i8_qk", 889), ("flash_prefix_i8_quant", 901))
       for f in ("", "_f32")},
    **{f"grouped_conv{f}_g8": "korean_f5_tts_tpu/ops/grouped_conv.py:69" for f in ("", "_f32")},
}
SOURCES = {
    "flash_prefix": "korean_f5_tts_tpu_torch/csrc/flash_prefix.cu",
    "ff_block": "korean_f5_tts_tpu_torch/csrc/ff_block.cu",
    "grouped_conv": "korean_f5_tts_tpu_torch/csrc/grouped_conv.cu",
    "ff_block_int8": "korean_f5_tts_tpu_torch/csrc/ff_block_int8.cu",
    "ln_mod_matmul_int8": "korean_f5_tts_tpu_torch/csrc/fused_linears_int8.cu",
    "proj_gated_residual_int8": "korean_f5_tts_tpu_torch/csrc/fused_linears_int8.cu",
    "qmatmul": "korean_f5_tts_tpu_torch/csrc/gemm_int8.cuh",
    "flash_prefix_lse": "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh",
    "flash_prefix_dq_lsein": "korean_f5_tts_tpu_torch/csrc/attn_bwd_wgmma.cuh",
    "flash_prefix_dq": "korean_f5_tts_tpu_torch/csrc/attn_bwd_wgmma.cuh",
    "flash_prefix_dkv": "korean_f5_tts_tpu_torch/csrc/attn_bwd_wgmma.cuh",
    **dict.fromkeys(("ln_mod_matmul", "proj_gated_residual"),
                    "korean_f5_tts_tpu_torch/csrc/fused_linears.cu"),
    "flash_prefix_rope": "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh",
    "flash_prefix_qkv": "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh",
    "flash_prefix_i8": "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh",
    "flash_prefix_i8_quant": "korean_f5_tts_tpu_torch/csrc/quant_heads.cu",
    "flash_prefix_f32": "korean_f5_tts_tpu_torch/csrc/flash_prefix.cu",
    "ff_block_f32": "korean_f5_tts_tpu_torch/csrc/ff_block.cu",
    "grouped_conv_f32": "korean_f5_tts_tpu_torch/csrc/grouped_conv.cu",
    "flash_prefix_lse_f32": "korean_f5_tts_tpu_torch/csrc/flash_prefix.cu",
    **dict.fromkeys(("flash_prefix_dq_lsein_f32", "flash_prefix_dq_f32", "flash_prefix_dkv_f32"),
                    "korean_f5_tts_tpu_torch/csrc/flash_prefix_train_f32.cu"),
    **dict.fromkeys(("ln_mod_matmul_f32", "proj_gated_residual_f32"),
                    "korean_f5_tts_tpu_torch/csrc/gemm_f32.cuh"),
    **dict.fromkeys(("flash_prefix_rope_f32", "flash_prefix_qkv_f32"),
                    "korean_f5_tts_tpu_torch/csrc/flash_prefix.cu"),
    "flash_prefix_i8_f32": "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh",
    "flash_prefix_i8_qk_f32": "korean_f5_tts_tpu_torch/csrc/flash_prefix_int8_f32.cu",
    "flash_prefix_i8_quant_f32": "korean_f5_tts_tpu_torch/csrc/quant_heads.cu",
    **{f"{base}{f}_d128": "korean_f5_tts_tpu_torch/csrc/flash_prefix_d128.cu"
       for base in ("flash_prefix", "flash_prefix_lse", "flash_prefix_dq_lsein", "flash_prefix_dq",
                    "flash_prefix_dkv", "flash_prefix_rope") for f in ("", "_f32")},
    # A, 10 and 18 at d = 128 in bf16: the attention core's d = 128 form
    **dict.fromkeys(("flash_prefix_d128", "flash_prefix_lse_d128", "flash_prefix_rope_d128"),
                    "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh"),
    # 11, 12 and 13 at d = 128 in bf16: the attention backward core's d = 128 forms
    **dict.fromkeys(("flash_prefix_dq_lsein_d128", "flash_prefix_dq_d128", "flash_prefix_dkv_d128"),
                    "korean_f5_tts_tpu_torch/csrc/flash_prefix_bwd_core_d128.cu"),
    # A, 10 and 18 at d = 128 in fp32: split 3xTF32
    **dict.fromkeys(("flash_prefix_f32_d128", "flash_prefix_lse_f32_d128",
                     "flash_prefix_rope_f32_d128"),
                    "korean_f5_tts_tpu_torch/csrc/flash_prefix_tf32_d128.cu"),
    # 11, 12 and 13 at d = 128 in fp32: split 3xTF32
    **dict.fromkeys(("flash_prefix_dq_lsein_f32_d128", "flash_prefix_dq_f32_d128",
                     "flash_prefix_dkv_f32_d128"),
                    "korean_f5_tts_tpu_torch/csrc/flash_prefix_train_tf32_d128.cu"),
    # 14 at d = 128: "qkpv" (bf16 and fp32 out) and "qk" on bf16 v on the attention
    # core's int8 D = 128 kernel, fp32 "qk" split 3xTF32
    **dict.fromkeys(("flash_prefix_i8_d128", "flash_prefix_i8_f32_d128",
                     "flash_prefix_i8_qk_d128"), "korean_f5_tts_tpu_torch/csrc/attn_wgmma.cuh"),
    "flash_prefix_i8_qk_f32_d128": "korean_f5_tts_tpu_torch/csrc/flash_prefix_int8_d128.cu",
    **{f"flash_prefix_i8_quant{f}_d128": "korean_f5_tts_tpu_torch/csrc/quant_heads.cu"
       for f in ("", "_f32")},
    **{f"grouped_conv{f}_g8": "korean_f5_tts_tpu_torch/csrc/grouped_conv.cu" for f in ("", "_f32")},
}
# published peaks of the H100 SXM (dense): the roofline a kernel's time is held against
# ("fp32": FFMA outside the tensor cores; "fp32_3xtf32": an fp32-accurate product on
# the tensor cores as three TF32 products, 494.7 TFLOP/s / 3, the least time for the
# fp32 forms' products, which bound() takes for kind "fp32" and prints the FFMA one beside)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "fp32_3xtf32": 494.7e12 / 3}
F32_REL = 1e-4  # fp32 forms against their plain versions: fp32 sums in another order
# the fp32 forms of 10-13: o and lse within 1e-5, the gradients within 1e-4
# (relative L2); a single-pass TF32 product (10 mantissa bits) would read
# ~1e-3 and fails both, which check_train_attention_f32 shows on the plain
# version with TF32 on
F32_ATTN_REL, F32_GRAD_REL = 1e-5, 1e-4
PEAK_BYTES = 3.35e12
# int8 kernels against their plain versions: both quantize the same values
# and sum the integer products exactly, but where the quantized value is
# computed first (LN statistics, GELU) fp32 sums in another order can flip a
# value at a rounding tie, which moves one product term by one quantization
# step (~1e-3 of a row's output): a few such flips per call stay far below
# INT8_REL. Kernels 9 and 6 quantize their bf16 input as it is, so without a
# GELU they must equal their plain versions exactly.
INT8_REL = 2e-3
# kernels 4 and 5 on fp32 rows: the same tie flips, with one rounding of the
# fp32 output and no bf16 step (2.2e-5 and 2.7e-5 at the main shape, PERF.md
# section 6); a bf16 step alone would read ~1e-3, so this bound tells the two
# apart, and check_int8_fp32_rows shows that on a bf16-rounded control.
# Kernel 14's fp32 form in "qkpv" is held to it too (exact integer products,
# p8 flips at a rint tie only, one fp32 rounding of the output; the control
# in check_fp32_attn_paths)
INT8_F32_REL = 2e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# kernels whose spills fail phase 1, by a substring of their names: the wgmma
# cores; the split 3xTF32 kernels (the fp32 forms of A, 10, 18, 19 in
# flash_prefix_fwd_tf32_kernel, of 11-13, of B, 7, 8 in ln_mod_gemm_tf32_kernel
# and gated_residual_gemm_tf32_kernel, of C in grouped_conv_tf32_kernel, of 14
# "qk" in flash_prefix_i8_qk_tf32_kernel, and the .tf32 probes); A's fp32 FFMA
# kernel at d = 128 (kept for timing A, 10 and 18); 14's pass; the d = 128
# forms (flash_prefix_d128.cu, flash_prefix_int8_d128.cu's
# flash_prefix_i8_qk_tf32_d128_kernel (14 fp32 "qk"), the attention core's
# attn_fwd_d128_wgmma_kernel (A, 10, 18 in bf16) and attn_i8_d128_wgmma_kernel
# (14's other forms), the backward core's
# attn_dkv_d128_wgmma_kernel (13 in bf16) and attn_dq_d128_wgmma_kernel (11
# and 12 in bf16), flash_prefix_tf32_d128_kernel (A,
# 10, 18 in fp32) and flash_prefix_dq_tf32_d128_kernel and
# flash_prefix_dkv_tf32_d128_kernel (11-13 in fp32): "d128" in their names; the
# mma.sync forward at D = 128, kept for timing A, 10 and 18)
SPILL_CHECKED = ("wgmma", "tf32", "flash_prefix_f32_kernel", "quant_heads_kernel", "d128",
                 "flash_prefix_fwd_kernelILi128")


def ptxas_faults(log: str) -> list[str]:
    """What ptxas reported against the checked kernels in a build log (empty
    when the library came from the build cache): spills of a function whose
    name holds one of SPILL_CHECKED (ptxas prints each function's spills on
    the line after "Function properties for <name>"; among them the D = 128
    forms of the backward core, attn_dkv_d128_wgmma_kernel and
    attn_dq_d128_wgmma_kernel, by "d128" and "wgmma"), and any wgmma it
    serialized (info C7513); and kernel 12's mma.sync loop at d = 64
    (flash_prefix_dq_kernel), which its form on the dq core replaced, and
    kernel 14's first loop at d = 128 (flash_prefix_i8_d128_kernel), which
    the attention core's int8 D = 128 kernel and the split 3xTF32 kernel
    replaced. The mma.sync dq and dk/dv kernels at d = 128
    (flash_prefix_dq_d128_kernel, flash_prefix_dkv_d128_kernel) stay built:
    f5_flash_prefix_d128_bwd_mma times them beside the backward core."""
    faults, name = [], ""
    if "flash_prefix_dq_kernel" in log:
        faults.append("kernel 12's mma.sync loop (flash_prefix_dq_kernel) is still built")
    if "flash_prefix_i8_d128_kernel" in log:
        faults.append("kernel 14's mma.sync loop at d = 128 (flash_prefix_i8_d128_kernel) is "
                      "still built")
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and any(k in name for k in SPILL_CHECKED) and spills.groups() != ("0", "0"):
            faults.append(f"{name}: {line.strip()}")
        if "C7513" in line:
            faults.append(line.strip())
        name = "" if spills else name
    return faults


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


_BLOCKER = []


def cuda_time_ms(fn, runs: int = 20) -> float:
    """Mean device time of fn() over `runs` launches, after one warm-up. ~2 ms
    products are enqueued first, so that the host queues all the launches
    while the device is still busy with them: a wrapper costs the host 10-35
    microseconds a call (more for one that checks three weights), more than
    the shortest kernels take, and without the head start the events would
    time the host. If the device had already reached the timed launches when
    the host had queued the last of them, and they took it less than 1.5x the
    host's time to queue them, the head start was too short: the measurement
    is repeated behind twice as many products."""
    import torch

    if not _BLOCKER:
        _BLOCKER.append(torch.zeros((8192, 8192), dtype=torch.bfloat16, device="cuda"))
    fn()
    torch.cuda.synchronize()
    for head in (1, 2, 4, 8, 16):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(head):
            torch.mm(_BLOCKER[0], _BLOCKER[0])
        start.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / runs
        caught_up = start.query()  # the device is already past the head start
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / runs
        if not caught_up or ms > 1.5 * host_ms:
            break
    return ms


def _tensors(*objs):
    for o in objs:
        if isinstance(o, dict):
            yield from _tensors(*o.values())
        elif isinstance(o, (list, tuple)):
            yield from _tensors(*o)
        elif o is not None:
            yield o


def bound(ops: float, io, kind: str = "bf16", ffma: bool = True) -> dict:
    """The least time the card could take: the larger of the operations over
    the published peak for their type and the bytes of `io` (each input read
    once, each output written once; tensors, or dicts and lists of them)
    over the memory rate. kind "fp32" (fp32-accurate products) takes the
    3xTF32 rate, and with ffma the bound at the FFMA rate is printed and kept
    beside it as "ffma_bound_ms"."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(io))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS["fp32_3xtf32" if kind == "fp32" else kind] * 1e3
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}
    rate = " at the 3xTF32 rate" if kind == "fp32" else ""
    print(f"  bound: {ops / 1e9:.2f} G{'OP' if kind == 'int8' else 'FLOP'} -> {t_ops:.4f} ms"
          f"{rate}, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms: {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}")
    if kind == "fp32" and ffma:
        out["ffma_bound_ms"] = max(ops / PEAK_OPS["fp32"] * 1e3, t_bytes)
        print(f"  at the FFMA rate (67 TFLOP/s, fp32 outside the tensor cores): "
              f"{out['ffma_bound_ms']:.4f} ms")
    return out


def compare(name: str, got, want, rel_bound: float,
            exact: bool = False, zero: bool = False) -> tuple[float, float]:
    """max-abs and relative-L2 error of got vs want (fp32), checked against
    max_abs <= 2**-6 * max(1, max|want|) (4 bf16 ulps at the output's scale)
    and rel <= rel_bound, or against max_abs == 0 when exact; also prints how
    many elements differ by more than 4 bf16 ulps of their own value. zero:
    the function is identically zero on these inputs (dq and dk at n = 1,
    where the one key gives dS = P (dP - D) = 0), so both sides hold rounding
    noise and only |got| <= 1e-5 is held."""
    import torch

    g, w = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    max_abs = (g - w).abs().max().item()
    rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
    abs_bound = 2.0 ** -6 * max(1.0, w.abs().max().item())
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)  # bf16 ulp of w
    past = int(((g - w).abs() > 4 * ulp).sum().item())
    if exact:
        abs_bound = 0.0
    ok = max_abs <= abs_bound and rel <= rel_bound
    if zero:
        rel_bound, abs_bound = math.inf, 1e-5
        max_abs = g.abs().max().item()
        ok = max_abs <= abs_bound
    print(f"  {name}: max_abs_err {max_abs:.3e} (bound {abs_bound:.3e}) "
          f"rel_err {rel:.3e} (bound {rel_bound:.1e}), {past} of {w.numel()} elements "
          f"past 4 bf16 ulps {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs, rel


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_sliced(q, k, v, kv):
    """The one PyTorch call that computes kernel A's function when every
    folded head has the same kv_len: the prefix mask is then a slice of the
    keys, and SDPA without a mask may take its flash or cuDNN backend. With
    unequal lengths the sliced call is another function, so it refuses them."""
    import torch

    lens = kv.tolist()
    if len(set(lens)) != 1:
        raise ValueError(f"sdpa_sliced: kv_lens differ ({sorted(set(lens))[:4]}...): the "
                         "sliced call would compute another function")
    L = lens[0]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None, :, :L], v[None, :, :L])[0]


def sdpa_times(q, k, v, kv, want) -> dict[str, tuple[float, float]]:
    """backend -> (ms, rel error to the plain version) of sdpa_sliced under
    each SDPA backend that accepts the call (a refused backend is printed
    and left out)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    call, out = sdpa_sliced(q, k, v, kv), {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:  # a library call, not the port: a backend may refuse these inputs
            with sdpa_kernel(backend):
                got = call()
        except RuntimeError as e:
            print(f"  SDPA {name} on sliced keys: refused ({str(e).splitlines()[0][:80]})")
            continue
        with sdpa_kernel(backend):
            ms = cuda_time_ms(call)
        out[name] = (ms, _rel(got, want))
        print(f"  SDPA {name} on sliced keys (no mask): {ms:.4f} ms, rel {out[name][1]:.1e} "
              "to plain")
    return out


def check_attention(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream

    def inputs(H, n, d, lens, past=None):
        q, k, v = (torch.randn((H, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        if past is not None:  # keys past kv_len that win every max unless masked first
            for h, L in enumerate(lens):
                k[h, L:] = past * q[h].float().mean(0).sign().to(torch.bfloat16)
        return q, k, v, torch.as_tensor(lens, dtype=torch.int32, device=dev)

    def case(label, H, n, d, lens, past=None):
        q, k, v, kv = inputs(H, n, d, lens, past)
        got = fp.flash_prefix_folded(q, k, v, kv)
        want = fp.prefix_attention_reference(q, k, v, kv)
        want[kv == 0] = 0  # no valid key: zeros (the TPU kernel's), not the plain uniform mean
        torch.cuda.synchronize()
        return compare(f"flash_prefix {label}", got, want, 1e-2), (q, k, v, kv, got, want)

    print("kernel A, prefix attention (bf16, rel bound 1e-2: p rounds to bf16 before P.V "
          "in the kernel, after normalisation in the plain version); on the TMA + wgmma "
          "attention core, d = 64 and d = 128 (128-key tiles)")
    (max_abs, _), (q, k, v, kv, got_main, want_main) = case(
        "main H=32 n=1536 d=64 kv=1376", 32, 1536, 64, [1376] * 32)
    for n in (1, 127, 128, 129, 1000):
        case(f"n={n} kv=n", 2, n, 64, [n] * 2)
    case("n=1000 kv=1", 4, 1000, 64, [1] * 4)
    case("n=1000 kv=700", 4, 1000, 64, [700] * 4)
    mixed = torch.randint(1, 1001, (6,), generator=gen, device=dev).tolist()
    case(f"n=1000 mixed kv={mixed + [0, 1000]} (0: zeros)", 8, 1000, 64, mixed + [0, 1000])
    case("H=1 n=1536 kv=1376", 1, 1536, 64, [1376])
    case("n=300 kv 1, 127, 128, 129, 255, 300, keys past kv_len at +-1e4", 6, 300, 64,
         [1, 127, 128, 129, 255, 300], past=1e4)
    case("n=300 d=128 mixed (the core's d = 128 form)", 4, 300, 128, [300, 1, 77, 129])

    ms = cuda_time_ms(lambda: fp.flash_prefix_folded(q, k, v, kv))
    plain_ms = cuda_time_ms(lambda: fp.prefix_attention_reference(q, k, v, kv))
    flop = 4.0 * 32 * 1536 * 1376 * 64  # every query row against this run's 1376 keys
    # the work this run's kv_lens need: every query row against 1376 keys
    b = bound(flop, (q, k, v, kv, got_main))
    print(f"  time at main shape: kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, bound / "
          f"time {b['bound_ms'] / ms:.3f}), plain {plain_ms:.4f} ms")
    # the mma.sync loop the core replaced, through its own entry point
    out = torch.empty_like(q)

    def run():
        cuda_build.check(lib.f5_flash_prefix_fwd_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(), out.data_ptr(), 32, 1536,
            fp.LOG2E / 8.0, dev.index, stream), "flash_prefix_fwd_mma")

    run()
    compare("flash_prefix main on the mma.sync loop (64 rows, 64-key tiles)", out, want_main,
            1e-2)
    mma_ms = cuda_time_ms(run)
    print(f"  kernel A designs at the main shape, one process: the attention core (the "
          f"wrapper) {ms:.4f} ms, the mma.sync loop {mma_ms:.4f} ms")
    # the library yardsticks: SDPA on keys sliced to the common kv_len under
    # each backend, and (labelled as what it is) SDPA with the prefix as a
    # boolean mask, which keeps it off its flash and cuDNN backends
    lib_times = sdpa_times(q, k, v, kv, want_main)
    valid = (torch.arange(1536, device=dev)[None, :] < kv[:, None])[:, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask_rel = _rel(sdpa(q, k, v, attn_mask=valid), want_main)
    mask_ms = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=valid))
    print(f"  SDPA with the prefix as a boolean attn_mask (no flash or cuDNN backend; not "
          f"the yardstick): {mask_ms:.4f} ms, rel {mask_rel:.1e} to plain")
    fastest = min(lib_times, key=lambda n: lib_times[n][0])
    library_ms = lib_times[fastest][0]
    print(f"  library yardstick: SDPA {fastest} on sliced keys {library_ms:.4f} ms; kernel A "
          f"{ms:.4f} ms = {ms / library_ms:.2f}x the library's time")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


# kernel B on the mma.sync core it had before, timed by this file's cuda_time_ms in one
# call with the core that replaced it (NVIDIA H100 80GB HBM3, 700.00 W; 0.2728 and 0.2733)
PARENT_FF_MS = 0.2728


def check_ff(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import ff_block as fb

    def uni(shape, bound):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).to(torch.bfloat16)

    def inputs(B, n, d=1024, dff=2048):
        h = torch.randn((B, n, d), generator=gen, device=dev).to(torch.bfloat16)
        sc, sh = uni((d,), 0.3), uni((d,), 0.3)
        gate = uni((d,), 1.0)
        w1, b1 = uni((dff, d), d ** -0.5), uni((dff,), d ** -0.5)
        w2, b2 = uni((d, dff), dff ** -0.5), uni((d,), dff ** -0.5)
        return h, sc, sh, gate, w1, b1, w2, b2

    print("kernel B, FF half-block (bf16, rel bound 5e-3: same rounding points, "
          "fp32 sums in another order)")
    args = inputs(2, 1536)
    max_abs, _ = compare("ff_block main m=3072 d=1024 dff=2048",
                         fb.ff_block_fused(*args), fb.ff_block_reference(*args), 5e-3)
    for m in (1000, 65, 1):
        ragged = inputs(1, m)
        compare(f"ff_block ragged m={m}", fb.ff_block_fused(*ragged),
                fb.ff_block_reference(*ragged), 5e-3)
    times = _timed(lambda: fb.ff_block_fused(*args), lambda: fb.ff_block_reference(*args),
                   4.0 * 3072 * 1024 * 2048, (args, args[0]),  # inputs and an output like h
                   kind="bf16")
    if times["ms"] > 0.5 * PARENT_FF_MS:
        fail(f"kernel B takes {times['ms']:.4f} ms, more than half of the mma.sync core's "
             f"{PARENT_FF_MS} ms")
    return {"max_abs_err": max_abs, **times}


# kernel C's edges: the 128-row block and its window (N, items), and the
# conv-pos layers' two weight draws
CONV_EDGES = ((1, 1), (1, 15), (2, 16), (3, 17), (1, 31), (2, 127), (1, 128), (3, 129),
              (2, 1376), (1, 1536))


def check_conv(gen, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from korean_f5_tts_tpu_torch.ops import grouped_conv as gc

    def weights(C=1024, k=31, groups=16):
        bound = (C // groups * k) ** -0.5
        w = ((torch.rand((k, C // groups, C), generator=gen, device=dev) * 2 - 1)
             * bound).to(torch.bfloat16)
        b = ((torch.rand((C,), generator=gen, device=dev) * 2 - 1) * bound).to(torch.bfloat16)
        return w, b

    def act(B, N, C=1024):
        return torch.randn((B, N, C), generator=gen, device=dev).to(torch.bfloat16)

    print("kernel C, grouped conv1d + Mish on TMA + wgmma (bf16, rel bound 5e-3: fp32 sums "
          "in another order)")
    layers = [weights(), weights()]  # ConvPositionEmbedding's two convolutions
    x = act(2, 1536)
    w, b = layers[0]
    max_abs, _ = compare("grouped_conv main B=2 N=1536 C=1024 k=31",
                         gc.grouped_conv1d_mish(x, w, b, 16),
                         gc.grouped_conv1d_mish_reference(x, w, b, 16), 5e-3)
    for i, (wl, bl) in enumerate(layers):
        for B, N in CONV_EDGES:
            xe = act(B, N)
            for bias, mish in ((True, True), (False, True), (True, False)):
                be = bl if bias else None
                compare(f"grouped_conv layer {i} B={B} N={N} bias={bias} mish={mish}",
                        gc.grouped_conv1d_mish(xe, wl, be, 16, mish),
                        gc.grouped_conv1d_mish_reference(xe, wl, be, 16, mish), 5e-3)
    out = {"max_abs_err": max_abs,
           **_timed(lambda: gc.grouped_conv1d_mish(x, w, b, 16),
                    lambda: gc.grouped_conv1d_mish_reference(x, w, b, 16),
                    2.0 * 2 * 1536 * 1024 * (1024 // 16) * 31, (x, w, b, x), kind="bf16")}
    # no one PyTorch call computes conv + bias + Mish; printed beside the kernel:
    # cuDNN's grouped conv with its bias in bf16, then Mish
    wt = w.permute(2, 1, 0).contiguous()
    xt = x.transpose(1, 2)
    conv = lambda: F.conv1d(xt, wt, b, padding=15, groups=16)
    composition = lambda: F.mish(conv())
    print(f"  F.conv1d(groups=16) with bias, bf16: {cuda_time_ms(conv):.4f} ms; + Mish: "
          f"{cuda_time_ms(composition):.4f} ms (kernel {out['ms']:.4f} ms)")
    return out


# kernel C's group widths past 64 channels, each at its dim (16 groups): the
# edges of the 128-row block and window, and the main path's shape
WIDTH_EDGES = ((1, 1), (2, 16), (1, 31), (3, 129), (2, 1376), (2, 1537))


def check_conv_widths(gen, dev) -> None:
    """Kernel C in bf16 and fp32 at every group width it takes besides 64
    (16, 32 and 128 channels a group: dim 256, 512, 2048) against its plain
    version (bf16 rel 5e-3, fp32 F32_REL with cuDNN's TF32 off), timed at
    B 2, N 1536; and at 48 channels a group (dim 768: F5TTS_Small,
    E2TTS_Small), where the wrapper refuses the shape and conv-pos takes the
    plain convolution by its shape rule, kernel C's counters unmoved."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import conv_position_embedding
    from korean_f5_tts_tpu_torch.ops import grouped_conv as gc

    print("kernel C at group widths 16, 32, 128 (dim 256, 512, 2048), bf16 (rel 5e-3) and fp32 "
          f"(rel {F32_REL:.0e})")
    for cg in (16, 32, 128):
        C = 16 * cg
        for dtype, rel in ((torch.bfloat16, 5e-3), (torch.float32, F32_REL)):
            bnd = (cg * 31) ** -0.5
            w = ((torch.rand((31, cg, C), generator=gen, device=dev) * 2 - 1) * bnd).to(dtype)
            b = ((torch.rand((C,), generator=gen, device=dev) * 2 - 1) * bnd).to(dtype)
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            for B, N in WIDTH_EDGES:
                x = torch.randn((B, N, C), generator=gen, device=dev).to(dtype)
                for bias, mish in ((True, True), (False, True), (True, False)):
                    be = b if bias else None
                    compare(f"grouped_conv {tag} cg={cg} B={B} N={N} bias={bias} mish={mish}",
                            gc.grouped_conv1d_mish(x, w, be, 16, mish),
                            gc.grouped_conv1d_mish_reference(x, w, be, 16, mish), rel)
            x = torch.randn((2, 1536, C), generator=gen, device=dev).to(dtype)
            ms = cuda_time_ms(lambda: gc.grouped_conv1d_mish(x, w, b, 16))
            plain_ms = cuda_time_ms(lambda: gc.grouped_conv1d_mish_reference(x, w, b, 16))
            flop = 2.0 * 2 * 1536 * C * cg * 31
            print(f"  grouped_conv {tag} cg={cg} B=2 N=1536 C={C}: kernel {ms:.4f} ms "
                  f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
    # 48 channels a group: no kernel, by the shape rule
    x = torch.randn((2, 1536, 768), generator=gen, device=dev).to(torch.bfloat16)
    bnd = (48 * 31) ** -0.5
    conv = {f"conv{i}": {"w": ((torch.rand((31, 48, 768), generator=gen, device=dev) * 2 - 1)
                               * bnd).to(torch.bfloat16),
                         "b": ((torch.rand((768,), generator=gen, device=dev) * 2 - 1)
                               * bnd).to(torch.bfloat16)} for i in (1, 2)}
    try:
        gc.grouped_conv1d_mish(x, conv["conv1"]["w"], conv["conv1"]["b"], 16)
    except ValueError as e:
        print(f"  48 channels a group: the kernel's wrapper refuses the shape ({e})")
    else:
        fail("kernel C took 48 channels a group")
    before = (gc.launches, gc.launches_f32)
    got = conv_position_embedding(conv, x)
    plain = conv_position_embedding(conv, x, kernels=False)
    y = gc.grouped_conv1d_mish_train(x, conv["conv1"]["w"], conv["conv1"]["b"], 16)
    want = gc.grouped_conv1d_mish_train(y, conv["conv2"]["w"], conv["conv2"]["b"], 16)
    moved = (gc.launches, gc.launches_f32) != before
    same = torch.equal(got, want) and torch.equal(plain, want)
    print(f"  conv-pos at dim 768: the plain grouped conv in bf16 with kernels and without "
          f"({'equal' if same else 'DIFFERENT'}), kernel C's counters "
          f"{'MOVED' if moved else 'unmoved'}")
    if moved or not same or not torch.isfinite(got).all():
        fail("conv-pos at 48 channels a group did not take the plain convolution by its shape")


def check_odd_lengths(gen, dev) -> None:
    """The sequence lengths the UNetT and MMDiT paths give the attention
    kernels, which no DiT path does: kernel A (bf16, fp32) at n 1537 (UNetT's
    time token on the 1536 bucket, valid prefix 1377) and n 1696 (MMDiT's 160
    text tokens first, then the 1536 bucket: valid prefix 1536), and kernels
    10, 11, 13 (bf16, fp32) at n 1281 (UNetT training at 1280 frames), each
    against its plain version, a partial last query and key tile at each."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    print("kernel A at n 1537 and 1696, kernels 10, 11, 13 at n 1281 (bf16 rel 1e-2, fp32 "
          f"{F32_ATTN_REL:.0e} / {F32_GRAD_REL:.0e})")
    for n, lens in ((1537, (1537, 1377)), (1696, (1696, 1536))):
        for dtype, rel in ((torch.bfloat16, 1e-2), (torch.float32, F32_ATTN_REL)):
            q, k, v = (torch.randn((32, n, 64), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            kv = torch.as_tensor([lens[0]] * 16 + [lens[1]] * 16, dtype=torch.int32, device=dev)
            compare(f"kernel A {dtype} H=32 n={n} kv={list(lens)}", fp.flash_prefix_folded(q, k, v, kv),
                    fp.prefix_attention_reference(q, k, v, kv), rel)
    n = 1281
    for dtype in (torch.bfloat16, torch.float32):
        rel, grel = (1e-2, 1e-2) if dtype == torch.bfloat16 else (F32_ATTN_REL, F32_GRAD_REL)
        q, k, v, do = (torch.randn((128, n, 64), generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        kv = torch.as_tensor([n] * 64 + [1100] * 64, dtype=torch.int32, device=dev)
        o, lse = fp.prefix_attention_lse_reference(q, k, v, kv)
        dvec = (do.float() * o.float()).sum(-1)
        o10, lse10 = fp.flash_prefix_folded_lse(q, k, v, kv)
        compare(f"kernel 10 o {dtype} H=128 n={n}", o10, o, rel)
        compare(f"kernel 10 lse {dtype} H=128 n={n}", lse10, lse, F32_ATTN_REL)
        compare(f"kernel 11 dq {dtype} H=128 n={n}", fp.flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv),
                fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv), grel)
        dk, dv = fp.flash_prefix_dkv(q, k, v, do, dvec, lse, kv)
        dk_p, dv_p = fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv)
        compare(f"kernel 13 dk {dtype} H=128 n={n}", dk, dk_p, grel)
        compare(f"kernel 13 dv {dtype} H=128 n={n}", dv, dv_p, grel)
        del q, k, v, do, o, lse, dvec, o10, lse10, dk, dv, dk_p, dv_p
        torch.cuda.empty_cache()


def faster_than_plain(name: str, r: dict) -> None:
    """The fp32 forms of B, C, 7 and 8 run on the tensor cores as 3xTF32
    products: each must beat its plain version (cuBLAS's fp32 products,
    cuDNN's fp32 convolution) in the same run."""
    print(f"  {name}: {r['ms']:.4f} ms against its plain version's {r['plain_ms']:.4f} "
          f"({r['ms'] / r['plain_ms']:.2f}x)")
    if r["ms"] >= r["plain_ms"]:
        fail(f"{name} is slower than its plain version")


def check_fp32_forms(gen, dev) -> dict[str, dict]:
    """The fp32 forms of kernels A, B and C at the main shapes and at ragged
    ones against their plain versions (which compute in fp32 whatever the
    input; the plain conv with cuDNN's TF32 off, as everywhere in this
    script). A (d = 64), B and C are split 3xTF32 products on the tensor
    cores, at d = 128 too; the bound takes the 3xTF32 rate, the FFMA one
    printed beside. A TF32 control for A, B and C (the plain version with
    TF32 on must fail F32_REL); B and C must beat their plain versions; C at
    the bf16 form's edges (CONV_EDGES, two weight draws, without bias,
    without Mish); A beside the fp32 library attention on keys sliced to the
    common kv_len, C beside the fp32 library composition (cuDNN's grouped
    conv with its bias, TF32 off, then Mish; no one call computes C)."""
    import torch

    from korean_f5_tts_tpu_torch.ops import ff_block as fb
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
    from korean_f5_tts_tpu_torch.ops import grouped_conv as gc

    def uni(shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    out = {}
    print(f"kernel A on fp32 operands (split 3xTF32; rel bound {F32_REL:.0e}: nothing is rounded "
          "below fp32)")

    def attn_case(label, H, n, d, lens):
        q, k, v = (torch.randn((H, n, d), generator=gen, device=dev) for _ in range(3))
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        got = fp.flash_prefix_folded(q, k, v, kv)
        live = [i for i, length in enumerate(lens) if length > 0]
        for i, length in enumerate(lens):  # no valid key: zeros, as the bf16 form
            if length == 0 and got[i].abs().max().item():
                fail(f"flash_prefix fp32 {label}: head {i} with no valid key is not zero")
        want = fp.prefix_attention_reference(q[live], k[live], v[live], kv[live])
        return compare(f"flash_prefix fp32 {label}", got[live], want, F32_REL), (q, k, v, kv, got)

    (max_abs, _), (q, k, v, kv, got) = attn_case("main H=32 n=1536 d=64 kv=1376", 32, 1536, 64,
                                                [1376] * 32)
    attn_case("n=1000 kv=[0, 1, 700, 1000]", 4, 1000, 64, [0, 1, 700, 1000])
    attn_case("n=300 d=128 mixed", 4, 300, 128, [300, 1, 77, 129])
    want = fp.prefix_attention_reference(q, k, v, kv)
    tf32_control("kernel A fp32", lambda: fp.prefix_attention_reference(q, k, v, kv), want,
                 F32_REL)
    out["flash_prefix_f32"] = {
        "max_abs_err": max_abs,
        **_timed(lambda: fp.flash_prefix_folded(q, k, v, kv),
                 lambda: fp.prefix_attention_reference(q, k, v, kv),
                 4.0 * 32 * 1536 * 1376 * 64, (q, k, v, kv, got), kind="fp32")}
    # the one PyTorch call for the same function on the same fp32 operands, as
    # check_attention times it for the bf16 form (keys sliced to the common
    # kv_len); used nowhere in the port
    lib = efficient_f32_sliced(q, k, v, kv)
    lib_rel = _rel(lib(), want)
    print(f"  library (aten._scaled_dot_product_efficient_attention, fp32, keys sliced to the "
          f"common kv_len 1376): rel {lib_rel:.3e} to the plain version (bound {F32_REL:.0e}: "
          "the yardstick must be fp32-accurate too)")
    if lib_rel > F32_REL:
        fail("the fp32 library attention is not fp32-accurate: no fair yardstick")
    out["flash_prefix_f32"]["library_ms"] = lib_ms = cuda_time_ms(lib)
    valid = (torch.arange(1536, device=dev)[None, :] < kv[:, None])[:, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask_ms = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=valid))
    print(f"  library {lib_ms:.4f} ms: kernel A fp32 takes "
          f"{out['flash_prefix_f32']['ms'] / lib_ms:.2f}x its time; F.scaled_dot_product_"
          f"attention with a boolean mask {mask_ms:.4f} ms (printed, not the yardstick)")

    print(f"kernel B on fp32 operands (split 3xTF32 on wgmma; rel bound {F32_REL:.0e})")

    def ff_inputs(m, d=1024, dff=2048):
        return (torch.randn((1, m, d), generator=gen, device=dev), uni((d,), 0.3), uni((d,), 0.3),
                uni((d,), 1.0), uni((dff, d), d ** -0.5), uni((dff,), d ** -0.5),
                uni((d, dff), dff ** -0.5), uni((d,), dff ** -0.5))

    args = ff_inputs(3072)
    got, want = fb.ff_block_fused(*args), fb.ff_block_reference(*args)
    max_abs, _ = compare("ff_block fp32 main m=3072 d=1024 dff=2048", got, want, F32_REL)
    # the residual h dilutes a product's error in out (a TF32 product reads
    # below F32_REL there): the gated branch out - h is held as well
    compare("ff_block fp32 main, the gated branch out - h", got - args[0], want - args[0],
            F32_REL)
    for m in (1000, 1):
        ragged = ff_inputs(m)
        compare(f"ff_block fp32 ragged m={m}", fb.ff_block_fused(*ragged),
                fb.ff_block_reference(*ragged), F32_REL)
    tf32_control("kernel B fp32", lambda: fb.ff_block_reference(*args), want, F32_REL,
                 base=args[0])
    out["ff_block_f32"] = {
        "max_abs_err": max_abs,
        **_timed(lambda: fb.ff_block_fused(*args), lambda: fb.ff_block_reference(*args),
                 4.0 * 3072 * 1024 * 2048, (args, args[0]), kind="fp32")}
    faster_than_plain("ff_block_f32", out["ff_block_f32"])

    print(f"kernel C on fp32 operands (split 3xTF32, each tap summed apart; rel bound "
          f"{F32_REL:.0e})")

    def conv_inputs(B, N, C=1024, k=31):
        return torch.randn((B, N, C), generator=gen, device=dev), *conv_weights(C, k)

    def conv_weights(C=1024, k=31):
        bound = (C // 16 * k) ** -0.5
        return uni((k, C // 16, C), bound), uni((C,), bound)

    x, w, b = conv_inputs(2, 1536)
    got = gc.grouped_conv1d_mish(x, w, b, 16)
    want = gc.grouped_conv1d_mish_reference(x, w, b, 16)
    max_abs, _ = compare("grouped_conv fp32 main B=2 N=1536 C=1024 k=31", got, want, F32_REL)
    xr, wr, br = conv_inputs(1, 1000)
    compare("grouped_conv fp32 ragged N=1000", gc.grouped_conv1d_mish(xr, wr, br, 16),
            gc.grouped_conv1d_mish_reference(xr, wr, br, 16), F32_REL)
    compare("grouped_conv fp32 no bias, no mish", gc.grouped_conv1d_mish(xr, wr, None, 16, False),
            gc.grouped_conv1d_mish_reference(xr, wr, None, 16, False), F32_REL)
    # the bf16 form's edges (check_conv): the 128-row block and its window, items,
    # the two weight draws of ConvPositionEmbedding
    for i, (wl, bl) in enumerate((conv_weights(), conv_weights())):
        for B, N in CONV_EDGES:
            xe = torch.randn((B, N, 1024), generator=gen, device=dev)
            for bias, mish in ((True, True), (False, True), (True, False)):
                be = bl if bias else None
                compare(f"grouped_conv fp32 layer {i} B={B} N={N} bias={bias} mish={mish}",
                        gc.grouped_conv1d_mish(xe, wl, be, 16, mish),
                        gc.grouped_conv1d_mish_reference(xe, wl, be, 16, mish), F32_REL)
    tf32_control("kernel C fp32", lambda: gc.grouped_conv1d_mish_reference(x, w, b, 16), want,
                 F32_REL)
    out["grouped_conv_f32"] = {
        "max_abs_err": max_abs,
        **_timed(lambda: gc.grouped_conv1d_mish(x, w, b, 16),
                 lambda: gc.grouped_conv1d_mish_reference(x, w, b, 16),
                 2.0 * 2 * 1536 * 1024 * (1024 // 16) * 31, (x, w, b, got), kind="fp32")}
    faster_than_plain("grouped_conv_f32", out["grouped_conv_f32"])
    # no one PyTorch call computes conv + bias + Mish; the fp32 composition is
    # printed beside the kernel and kept in the kernels line
    # (library_composition_ms), with TF32 off (fp32-accurate) and on (not)
    wt = w.permute(2, 1, 0).contiguous()
    composition = lambda: torch.nn.functional.mish(
        torch.nn.functional.conv1d(x.transpose(1, 2), wt, b, padding=15, groups=16))
    comp_rel = _rel(composition().transpose(1, 2), want)
    comp_ms = cuda_time_ms(composition)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_rel = _rel(composition().transpose(1, 2), want)
        tf32_ms = cuda_time_ms(composition)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["grouped_conv_f32"]["library_composition_ms"] = comp_ms
    print(f"  library: none; F.conv1d(groups=16) with bias, then F.mish, fp32 (cuDNN TF32 off) "
          f"{comp_ms:.4f} ms, rel {comp_rel:.3e} to plain (C fp32 takes "
          f"{out['grouped_conv_f32']['ms'] / comp_ms:.2f}x its time); with cuDNN's TF32 on "
          f"{tf32_ms:.4f} ms, rel {tf32_rel:.3e} (not fp32-accurate)")
    return out


def check_fp32_attn_paths(gen, dev) -> dict[str, dict]:
    """The fp32 forms of kernels 7, 8, 18, 19, 14 and its quantization pass
    (what the offline entry points' default fp32 weights run under attn_path
    and attn_int8) at the main shapes and at ragged and edge cases, against
    their plain versions (which compute in fp32; TF32 off): 7, 8, 18, 19
    within F32_REL (nothing is rounded below fp32), 14 "qk" (exact int8
    scores, split 3xTF32 P.V) within F32_ATTN_REL, the bound of every fp32
    attention forward (its plain output through bf16 and its plain version
    with TF32 on must fail it), 18 against 19 and
    against kernel A's fp32 form on torch-roped inputs to the bit (one kernel
    over three layouts), 14 "qkpv" (the attention core's int8 form with an
    fp32 output) within INT8_F32_REL (p8 ties; the plain output rounded
    through bf16 must fail that bound), both modes' quantization error
    against kernel A's fp32 form held by QUANT_TAIL's count rule, the pass to
    the bit. Times with the bound of their products at the 3xTF32 rate (the
    FFMA one printed beside; 14's at the int8 rate, "qkpv"'s products' type,
    and "qk"'s at the 3xTF32 rate of its fp32 p.v), no library call for any
    of them (as their bf16 rows)."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import apply_rope, rope_cos_sin
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    def uni(shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    def linear(n, k):
        return {"w": uni((n, k), k ** -0.5), "b": uni((n,), k ** -0.5)}

    out = {}
    print(f"kernels 7 and 8 on fp32 operands (split 3xTF32 on wgmma; rel bound {F32_REL:.0e})")
    h = torch.randn((2, 1536, 1024), generator=gen, device=dev)
    sc, sh, gate = uni((1024,), 0.3), uni((1024,), 0.3), uni((1024,), 1.0)
    ps = [linear(1024, 1024) for _ in range(3)]
    got = fl.ln_mod_matmul(h, sc, sh, ps)
    if got.dtype != torch.float32:
        fail(f"ln_mod_matmul fp32 wrote {got.dtype}")
    max_abs, _ = compare("ln_mod_matmul fp32 main m=3072 d=1024 n=3x1024", got,
                         fl.ln_mod_matmul_reference(h, sc, sh, ps), F32_REL)
    for m, seg in ((1000, ps), (1000, ps[:1]), (65, ps[:2]), (1, ps)):
        hr = torch.randn((1, m, 1024), generator=gen, device=dev)
        compare(f"ln_mod_matmul fp32 ragged m={m}, {len(seg)} linear(s)",
                fl.ln_mod_matmul(hr, sc, sh, seg), fl.ln_mod_matmul_reference(hr, sc, sh, seg),
                F32_REL)
    tf32_control("kernel 7 fp32", lambda: fl.ln_mod_matmul_reference(h, sc, sh, ps),
                 fl.ln_mod_matmul_reference(h, sc, sh, ps), F32_REL)
    out["ln_mod_matmul_f32"] = {"max_abs_err": max_abs, **_timed(
        lambda: fl.ln_mod_matmul(h, sc, sh, ps), lambda: fl.ln_mod_matmul_reference(h, sc, sh, ps),
        2.0 * 3072 * 1024 * 3072, (h, sc, sh, ps, got), kind="fp32")}
    faster_than_plain("ln_mod_matmul_f32", out["ln_mod_matmul_f32"])
    print("  library: none (as for the bf16 form)")
    a = torch.randn((2, 1536, 1024), generator=gen, device=dev)
    p = linear(1024, 1024)
    got = fl.proj_gated_residual(a, h, gate, p)
    want = fl.proj_gated_residual_reference(a, h, gate, p)
    max_abs, _ = compare("proj_gated_residual fp32 main m=3072 d=1024", got, want, F32_REL)
    compare("proj_gated_residual fp32 main, the gated branch out - h", got - h, want - h,
            F32_REL)
    for m in (1000, 65, 1):
        compare(f"proj_gated_residual fp32 ragged m={m}",
                fl.proj_gated_residual(a[:1, :m].contiguous(), h[:1, :m].contiguous(), gate, p),
                fl.proj_gated_residual_reference(a[:1, :m], h[:1, :m], gate, p), F32_REL)
    tf32_control("kernel 8 fp32", lambda: fl.proj_gated_residual_reference(a, h, gate, p), want,
                 F32_REL, base=h)
    out["proj_gated_residual_f32"] = {"max_abs_err": max_abs, **_timed(
        lambda: fl.proj_gated_residual(a, h, gate, p),
        lambda: fl.proj_gated_residual_reference(a, h, gate, p), 2.0 * 3072 * 1024 * 1024,
        (a, h, gate, p, got), kind="fp32")}
    faster_than_plain("proj_gated_residual_f32", out["proj_gated_residual_f32"])
    print("  library: none (as for the bf16 form)")
    del h, a, got

    print(f"kernels 18 and 19 on fp32 operands (kernel A's split 3xTF32 kernel with strided "
          f"heads and the rotation in fp32; rel bound {F32_REL:.0e}; 18, 19 and A's fp32 form on "
          "torch-roped inputs equal to the bit)")

    def tables(n):
        return tuple(torch.from_numpy(t).to(dev) for t in rope_cos_sin(n, 64))

    def merge(o):
        B, H, n, d = o.shape
        return o.transpose(1, 2).reshape(B, n, H * d)

    def rope_case(label, B, H, n, lens, pe, past=0.0):
        qkv = torch.randn((B, n, 3 * H * 64), generator=gen, device=dev)
        for i, length in enumerate(lens if past else ()):
            sign = torch.randint(0, 2, (n - length, 2 * H * 64), generator=gen, device=dev)
            qkv[i, length:, H * 64:] = past * (2.0 * sign - 1)
        q, k, v = (t.contiguous() for t in fp.qkv_unpack(qkv, H))
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        cos, sin = tables(n)
        got18 = fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin, pe)
        got19 = fp.flash_prefix_qkv_attention(qkv, kv, H, cos, sin, pe)
        torch.cuda.synchronize()
        if got18.dtype != torch.float32 or got19.dtype != torch.float32:
            fail(f"kernels 18/19 fp32 {label}: wrote {got18.dtype}, {got19.dtype}")
        live = [i for i, length in enumerate(lens) if length > 0]
        for i, length in enumerate(lens):
            if length == 0 and (got18[i].abs().max().item() or got19[i].abs().max().item()):
                fail(f"kernels 18/19 fp32 {label}: item {i} with no valid key is not zero")
        want = fp.flash_prefix_rope_reference(q[live], k[live], v[live], kv[live], cos, sin, pe)
        e18 = compare(f"kernel 18 fp32 {label}", got18[live], want, F32_REL)[0]
        e19 = compare(f"kernel 19 fp32 {label}", got19[live], merge(want), F32_REL)[0]
        compare(f"kernel 18 vs 19 fp32 on the same values, {label}", merge(got18), got19,
                F32_REL, exact=True)
        via_a = fp.flash_prefix_attention(fp.rope_reference(q[live], cos, sin, pe),
                                          fp.rope_reference(k[live], cos, sin, pe), v[live],
                                          kv[live])
        compare(f"kernel 18 fp32 vs A's fp32 form on torch-roped q, k, {label}", got18[live],
                via_a, F32_REL, exact=True)
        return (e18, e19), (qkv, q, k, v, kv, cos, sin, got18, got19)

    (e18, e19), (qkv, q, k, v, kv, cos, sin, got18, got19) = rope_case(
        "main B=2 heads=16 n=1536 kv=1376", 2, 16, 1536, [1376, 1376], None)
    rope_case("n=300 kv=[300, 1, 129] pe_attn_head=1", 3, 2, 300, [300, 1, 129], 1)
    for B, H, n, lens, pe, past in QKV_EDGES:
        rope_case(f"B={B} heads={H} n={n} kv={lens} pe_attn_head={pe}"
                  f"{f' past=+-{past:g}' if past else ''}", B, H, n, lens, pe, past)
    flop = 4.0 * 32 * 1536 * 1376 * 64  # every query row against this run's 1376 keys
    tf32_control("kernel 18 fp32", lambda: fp.flash_prefix_rope_reference(q, k, v, kv, cos, sin),
                 fp.flash_prefix_rope_reference(q, k, v, kv, cos, sin), F32_REL)
    tf32_control("kernel 19 fp32", lambda: fp.flash_prefix_qkv_reference(qkv, kv, 16, cos, sin),
                 fp.flash_prefix_qkv_reference(qkv, kv, 16, cos, sin), F32_REL)
    out["flash_prefix_rope_f32"] = {"max_abs_err": e18, **_timed(
        lambda: fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin),
        lambda: fp.flash_prefix_rope_reference(q, k, v, kv, cos, sin), flop,
        (q, k, v, kv, cos, sin, got18), kind="fp32")}
    out["flash_prefix_qkv_f32"] = {"max_abs_err": e19, **_timed(
        lambda: fp.flash_prefix_qkv_attention(qkv, kv, 16, cos, sin),
        lambda: fp.flash_prefix_qkv_reference(qkv, kv, 16, cos, sin), flop,
        (qkv, kv, cos, sin, got19), kind="fp32")}
    # as the bf16 rows: no one library call computes 18's or 19's function;
    # the composition of the default path with the fp32 library attention
    # (keys sliced to the common kv_len) is printed beside them
    composed = cuda_time_ms(lambda: efficient_f32(
        apply_rope(q, cos, sin).reshape(32, 1536, 64),
        apply_rope(k, cos, sin).reshape(32, 1536, 64), v.reshape(32, 1536, 64), 1376))
    print(f"  library: none; apply_rope x 2 + the fp32 library attention on sliced keys "
          f"{composed:.4f} ms (18 fp32 {out['flash_prefix_rope_f32']['ms'] / composed:.2f}x, 19 "
          f"fp32 {out['flash_prefix_qkv_f32']['ms'] / composed:.2f}x its time)")
    del qkv, q, k, v, got18, got19

    print("kernel 14 and its quantization pass on fp32 operands (the pass to the bit; 14 'qk' "
          f"within {F32_ATTN_REL:.0e}: exact integer scores on mma.sync .s8, P.V split 3xTF32; "
          "'qkpv' (the attention "
          f"core's int8 form, fp32 out) within {INT8_F32_REL:.0e}: p8 ties, no bf16 step; the "
          "quantization error against kernel A's fp32 form by QUANT_TAIL's count rule)")
    pass_err = []  # the pass's largest difference from its plain version, per case

    def i8_case(label, B, H, n, lens, past=0.0, held=False):
        q, k, v = (torch.randn((B, H, n, 64), generator=gen, device=dev) for _ in range(3))
        for i, length in enumerate(lens if past else ()):
            for t in (k, v):
                sign = torch.randint(0, 2, (H, n - length, 64), generator=gen, device=dev)
                t[i, :, length:] = past * (2.0 * sign - 1)
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        err = 0.0
        for pv_i8 in (True, False):
            got = fp.quantize_heads(q, k, v, pv_i8)
            q8, k8, vq, c, sv = fp._quantize_qkv(q, k, v, pv_i8)
            want = (q8, k8, fp._v8_kernel_layout(vq) if pv_i8 else vq, c, sv)
            for name, g, w in zip(("q8", "k8", "v8" if pv_i8 else "v", "c", "sv"), got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    fail(f"quantization pass fp32 {label}: {name} is {tuple(g.shape)} {g.dtype}, "
                         f"the plain version's {tuple(w.shape)} {w.dtype}")
                diff = (g.float() - w.float()).abs()
                err = max(err, diff.max().item() if diff.numel() else 0.0)
                if not torch.equal(g, w):
                    fail(f"quantization pass fp32 {label}: {name} differs from the plain version")
        print(f"  quantization pass fp32 {label}: equal to the plain version to the bit, both "
              f"modes (max abs difference {err:.3e})")
        pass_err.append(err)
        lens_h = kv.repeat_interleave(H)
        live = lens_h > 0
        fold = [t.reshape(B * H, n, 64) for t in (q, k, v)]
        via_a = fp.flash_prefix_folded(*fold, lens_h)
        rows = (torch.arange(n, device=dev)[None, :, None] < lens_h[:, None, None])[live]
        valid = int(rows.sum().item()) * 64
        errs = {}
        for mode, pv_i8, rel_bound in (("qkpv", True, INT8_F32_REL), ("qk", False, F32_ATTN_REL)):
            got = fp.flash_prefix_attention_i8(q, k, v, kv, pv_i8=pv_i8).reshape(B * H, n, 64)
            want = fp.flash_prefix_i8_reference(q, k, v, lens_h, pv_i8=pv_i8)
            torch.cuda.synchronize()
            if got.dtype != torch.float32:
                fail(f"flash_prefix_i8 fp32 {mode} {label}: wrote {got.dtype}")
            if (~live).any() and got[~live].abs().max().item() != 0:
                fail(f"flash_prefix_i8 fp32 {mode} {label}: a head with no valid key is not zero")
            if not live.any():
                continue
            errs[mode] = compare(f"flash_prefix_i8 fp32 {mode} {label}", got[live], want[live],
                                 rel_bound)[0]
            if held:
                control = _rel(want[live].bfloat16(), want[live])
                print(f"    control: the plain output through bf16 reads rel {control:.3e} "
                      f"(must fail {rel_bound:.0e})")
                if control <= rel_bound:
                    fail(f"flash_prefix_i8 fp32 {mode} {label}: the bound does not catch a bf16 "
                         "step")
                if mode == "qk":
                    tf32_control(f"kernel 14 fp32 qk {label}", lambda: fp.flash_prefix_i8_reference(
                        q, k, v, lens_h, pv_i8=False)[live], want[live], rel_bound)
            if past:
                continue
            err = (got - via_a).abs()[live] * rows
            base = (want - fp.prefix_attention_reference(*fold, lens_h)).abs()[live] * rows
            e_max, e_mean = err.max().item(), (err.sum() / valid).item()
            e_past, p_past = int((err > 3e-2).sum().item()), int((base > 3e-2).sum().item())
            tail = max(int(QUANT_TAIL * valid), p_past)
            print(f"    {mode} vs kernel A's fp32 form: max {e_max:.3e} (bound {QUANT_MAX}), "
                  f"{e_past} of {valid} past 3e-2 (bound {tail}), mean {e_mean:.3e} (bound "
                  f"5e-3){'' if held else ' (printed, not held: too few elements)'}")
            if held and (e_max > QUANT_MAX or e_past > tail or e_mean > 5e-3):
                fail(f"flash_prefix_i8 fp32 {mode} {label}: quantization error out of bounds")
        return errs.get("qkpv", 0.0), errs.get("qk", 0.0), (q, k, v, kv)

    max_abs, max_abs_qk, (q, k, v, kv) = i8_case("main B=2 heads=16 n=1536 kv=1376", 2, 16, 1536,
                                     [1376, 1376], held=True)
    i8_case("ragged B=8 heads=1 n=1000", 8, 1, 1000, [1, 1000, 700, 64, 65, 999, 333, 128],
            held=True)
    for B, H, n, lens, _, past in QKV_EDGES + I8_CHUNK_EDGES:
        for pst in ((past, 0.0) if past else (0.0,)):
            i8_case(f"B={B} heads={H} n={n} kv={lens}{f' past=+-{pst:g}' if pst else ''}", B, H,
                    n, lens, past=pst, held=not pst and int(QUANT_TAIL * H * 64 * sum(lens)) > 0)
    ops = 4.0 * 32 * 1536 * 1376 * 64
    q8, k8, v8k, c, sv = fp.quantize_heads(q, k, v, True)
    lens_h = kv.repeat_interleave(16)
    got = fp.flash_prefix_folded_i8(q8, k8, v8k, c, sv, lens_h, out_dtype=torch.float32)
    v8 = fp._v8_natural_layout(v8k, 1536)
    chunk_check("fp32 qkpv main", got, q8, k8, v8, c, sv, lens_h, True)
    print("  kernel 14 fp32 qkpv on quantized operands (the attention core's int8 form):")
    t14 = _timed(lambda: fp.flash_prefix_folded_i8(q8, k8, v8k, c, sv, lens_h,
                                                   out_dtype=torch.float32),
                 lambda: fp._i8_attention_plain(q8, k8, v8, c, sv, lens_h, True,
                                                fp.I8_KEY_CHUNK),
                 ops, (q8, k8, v8k, c, sv, lens_h, got), kind="int8")
    out["flash_prefix_i8_f32"] = {"max_abs_err": max_abs, **t14}
    vf = v.reshape(32, 1536, 64)
    got = fp.flash_prefix_folded_i8(q8, k8, vf, c, sv, lens_h, pv_i8=False)
    # "qk": S is an int8 product, P.V an fp32-accurate one; the bound takes
    # S's half at the int8 rate, counted here in 3xTF32-rate equivalents
    ops_qk = ops / 2 * (1 + PEAK_OPS["fp32_3xtf32"] / PEAK_OPS["int8"])
    print("  kernel 14 fp32 qk on quantized operands (S exact on mma.sync .s8, P.V split 3xTF32; "
          f"the bound's {ops / 2e9:.2f} GOP of S at the int8 rate, as "
          f"{ops_qk / 1e9 - ops / 2e9:.2f} GFLOP of 3xTF32):")
    t14qk = _timed(lambda: fp.flash_prefix_folded_i8(q8, k8, vf, c, sv, lens_h, pv_i8=False),
                   lambda: fp._i8_attention_plain(q8, k8, vf, c, sv, lens_h, False,
                                                  fp.I8_KEY_CHUNK),
                   ops_qk, (q8, k8, vf, c, lens_h, got), kind="fp32",
                   ffma=False)  # the equivalents above mean nothing at the FFMA rate
    out["flash_prefix_i8_qk_f32"] = {"max_abs_err": max_abs_qk, **t14qk}
    whole = cuda_time_ms(lambda: fp.flash_prefix_attention_i8(q, k, v, kv))
    fold = [t.reshape(32, 1536, 64) for t in (q, k, v)]
    a_ms = cuda_time_ms(lambda: fp.flash_prefix_folded(*fold, lens_h))
    print(f"  pass + 14 fp32 qkpv as sdpa calls them {whole:.4f} ms against kernel A's fp32 form "
          f"{a_ms:.4f} ms; library: none")
    print("  the quantization pass on fp32 (each input read once, each output written once):")
    tq = _timed(lambda: fp.quantize_heads(q, k, v, True),
                lambda: fp._v8_kernel_layout(fp._quantize_qkv(q, k, v, True)[2]), 0.0,
                (q, k, v, q8, k8, v8k, c, sv), kind="int8")
    out["flash_prefix_i8_quant_f32"] = {"max_abs_err": max(pass_err), **tq}
    return out


def _uni(gen, dev, shape, bound):
    import torch

    return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).to(torch.bfloat16)


def _int8_linear(gen, dev, n: int, k: int) -> dict:
    """An int8 linear of models/quant.py from uniform +-1/sqrt(k) bf16 weights."""
    from korean_f5_tts_tpu_torch.models.quant import quantize_linear

    qp = quantize_linear({"w": _uni(gen, dev, (n, k), k ** -0.5)})
    qp["b"] = _uni(gen, dev, (n,), k ** -0.5)
    return qp


def _edge_rows(gen, dev, m: int, k: int):
    """bf16 rows with an all-zero row (the 1e-6 scale floor) and a row with
    one large outlier."""
    import torch

    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    x[3] = 0
    x[7, 5] = 300.0
    return x


def _timed(fn, plain, ops: float, io, kind: str = "int8", ffma: bool = True) -> dict:
    """Times of the kernel and its plain version, and the bound for `ops`
    operations of `kind` over the inputs and outputs `io` (bound's ffma)."""
    ms = cuda_time_ms(fn)
    plain_ms = cuda_time_ms(plain)
    print(f"  time at main shape: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} T"
          f"{'OP' if kind == 'int8' else 'FLOP'}/s), plain {plain_ms:.4f} ms")
    b = bound(ops, io, kind, ffma)
    print(f"  the bound is {b['bound_ms'] / ms:.3f} of the kernel's time"
          + (f" ({b['ffma_bound_ms'] / ms:.3f} at the FFMA rate)" if "ffma_bound_ms" in b else ""))
    return {"ms": ms, "plain_ms": plain_ms, **b}


def check_qmatmul(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import qmatmul as qm

    print("kernel 9, dynamic-int8 matmul on the int8 core (bf16 x int8; exact without GELU: "
          f"the same int8 values, an exact product, the same fp32 epilogue; rel bound "
          f"{INT8_REL:.0e} with GELU)")

    def check(label, x, qp, bias, act):
        w, ws, n = qp["w_int8"], qp["w_scale"], qp["w_int8"].shape[0]
        return compare(f"qmatmul {label} (tile width {tile_width(x.shape[0], n, n)})",
                       qm.qmatmul(x, w, ws, bias, act),
                       qm.qmatmul_reference(x, w, ws, bias, act), INT8_REL, exact=act is None)

    x = torch.randn((6144, 1024), generator=gen, device=dev).to(torch.bfloat16)
    qp = _int8_linear(gen, dev, 1024, 1024)
    b = qp["b"]
    max_abs, _ = check("main M=3072 K=N=1024 + bias", x[:3072], qp, b, None)
    check("M=6144 K=N=1024 + bias (a batch of 2 with CFG)", x, qp, b, None)
    # the zero row (the 1e-6 scale floor) and an outlier row; M 1 and 100; K
    # 1040 (no multiple of the core's 128-deep k step), 2048, 4096 (the row
    # pass's limit); N 128 and 384 (no multiple of 256: 128-wide tiles only)
    for m, k, n in ((1000, 1024, 1024), (1, 1024, 1024), (100, 1040, 384), (1000, 2048, 128),
                    (1000, 4096, 1024), (100, 4096, 384)):
        xr = _edge_rows(gen, dev, max(m, 8), k)[:m]
        qpr = qp if (k, n) == (1024, 1024) else _int8_linear(gen, dev, n, k)
        rows = "zero+outlier rows" if m > 7 else "rows"
        for label, bias, act in (("+ bias", qpr["b"], None), ("no bias", None, None),
                                 ("+ bias + gelu_tanh", qpr["b"], "gelu_tanh"),
                                 ("no bias + gelu_tanh", None, "gelu_tanh")):
            check(f"M={m} K={k} N={n} {rows} {label}", xr, qpr, bias, act)
    times = _timed(lambda: qm.qmatmul(x[:3072], qp["w_int8"], qp["w_scale"], b),
                   lambda: qm.qmatmul_reference(x[:3072], qp["w_int8"], qp["w_scale"], b),
                   2.0 * 3072 * 1024 * 1024, (x[:3072], qp, x[:3072]))
    ms6 = cuda_time_ms(lambda: qm.qmatmul(x, qp["w_int8"], qp["w_scale"], b))
    b6 = bound(2.0 * 6144 * 1024 * 1024, (x, qp, x), "int8")
    print(f"  at M=6144: kernel {ms6:.4f} ms ({2.0 * 6144 * 1024 * 1024 / ms6 / 1e9:.1f} TOP/s), "
          f"the bound is {b6['bound_ms'] / ms6:.3f} of the kernel's time")
    # both tile widths, forced, beside gemm_tile_n's pick (N 1024: at M 3072
    # 96 tiles at 256 wide, 192 at 128; at M 6144 192 and 384)
    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream
    for m in (3072, 6144):
        xm = x[:m]
        want = qm.qmatmul_reference(xm, qp["w_int8"], qp["w_scale"], b)
        xq, xs = torch.empty((m, 1024), dtype=torch.int8, device=dev), torch.empty(m, device=dev)
        out, ms = torch.empty_like(want), {}
        for bn in (128, 256):
            def forced(bn=bn):
                cuda_build.check(lib.f5_qmatmul_width(
                    xm.data_ptr(), qp["w_int8"].data_ptr(), qp["w_scale"].data_ptr(),
                    b.data_ptr(), xq.data_ptr(), xs.data_ptr(), out.data_ptr(), m, 1024, 1024,
                    0, 0, bn, dev.index, stream), "qmatmul_width")
            out.zero_()
            forced()
            compare(f"kernel 9 at tile width {bn}, M={m}", out, want, INT8_REL, exact=True)
            ms[bn] = cuda_time_ms(forced)
        print(f"  kernel 9 tile widths at M={m} (picked: {tile_width(m, 1024, 1024)}): 128 -> "
              f"{ms[128]:.4f} ms, 256 -> {ms[256]:.4f} ms, ratio {ms[128] / ms[256]:.3f}")
    return {"max_abs_err": max_abs, **times}


def tile_width(m: int, n: int, seg_n: int) -> int:
    """The output tile width the int8 core picks on this card for an [m, n]
    product of seg_n-column segments (csrc/gemm_bf16.cuh:gemm_tile_n)."""
    from korean_f5_tts_tpu_torch.ops import cuda_build

    return cuda_build.library().f5_tile_width(m, n, seg_n, 1, 0)


def check_ln_mod_int8(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    print(f"kernel 5, int8 LN + modulate + qkv product (rel bound {INT8_REL:.0e}: one "
          "quantization step per tie flip of the fp32 LN output)")
    h = torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
    sc, sh = _uni(gen, dev, (1024,), 0.3), _uni(gen, dev, (1024,), 0.3)
    qps = [_int8_linear(gen, dev, 1024, 1024) for _ in range(3)]
    max_abs, _ = compare(f"ln_mod_matmul_int8 main m=3072 d=1024 n=3x1024 (tile width "
                         f"{tile_width(3072, 3072, 1024)})",
                         fl.ln_mod_matmul_int8(h, sc, sh, qps),
                         fl.ln_mod_matmul_int8_reference(h, sc, sh, qps), INT8_REL)
    # ragged rows with a zero and an outlier row; one and three segments; a
    # 384-wide segment (128-wide tiles only); d = 1040, no multiple of the
    # core's 128-deep k step (and past the 1024-value row pass)
    for m, d, n, nseg in ((1000, 1024, 1024, 3), (1000, 1024, 1024, 1), (65, 1024, 1024, 3),
                          (1000, 1024, 384, 3), (1000, 1040, 1024, 2)):
        hr = _edge_rows(gen, dev, m, d)[None]
        scr, shr = (sc, sh) if d == 1024 else (_uni(gen, dev, (d,), 0.3), _uni(gen, dev, (d,), 0.3))
        seg = qps[:nseg] if (d, n) == (1024, 1024) else [
            _int8_linear(gen, dev, n, d) for _ in range(nseg)]
        for label, shift in (("", shr), (", sh = 0 (zero y row)", torch.zeros_like(shr))):
            compare(f"ln_mod_matmul_int8 m={m} d={d} n={nseg}x{n} zero+outlier rows{label} "
                    f"(tile width {tile_width(m, nseg * n, n)})",
                    fl.ln_mod_matmul_int8(hr, scr, shift, seg),
                    fl.ln_mod_matmul_int8_reference(hr, scr, shift, seg), INT8_REL)
    times = _timed(lambda: fl.ln_mod_matmul_int8(h, sc, sh, qps),
                   lambda: fl.ln_mod_matmul_int8_reference(h, sc, sh, qps),
                   2.0 * 3072 * 1024 * 3072, (h, sc, sh, qps, h, h, h))
    # both tile widths, forced, beside gemm_tile_n's pick (at m = 1000 the
    # 256-wide tiles are one wave, 96 tiles, and the 128-wide two, 192)
    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream
    for m in (3072, 1000):
        hm = h.reshape(-1, 1024)[:m].contiguous()
        want = fl.ln_mod_matmul_int8_reference(hm, sc, sh, qps)
        yq, ys = torch.empty((m, 1024), dtype=torch.int8, device=dev), torch.empty(m, device=dev)
        out, ms = torch.empty_like(want), {}
        for bn in (128, 256):
            def forced(bn=bn):
                cuda_build.check(lib.f5_ln_mod_matmul_int8_width(
                    hm.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                    *(p["w_int8"].data_ptr() for p in qps), *(p["w_scale"].data_ptr() for p in qps),
                    *(p["b"].data_ptr() for p in qps), yq.data_ptr(), ys.data_ptr(),
                    out.data_ptr(), m, 1024, 1024, 3, 1e-6, 0, bn, dev.index, stream),
                    "ln_mod_matmul_int8_width")
            out.zero_()
            forced()
            compare(f"kernel 5 at tile width {bn}, m={m}", out, want, INT8_REL)
            ms[bn] = cuda_time_ms(forced)
        print(f"  kernel 5 tile widths at m={m} (picked: {tile_width(m, 3072, 1024)}): 128 -> "
              f"{ms[128]:.4f} ms, 256 -> {ms[256]:.4f} ms, ratio {ms[128] / ms[256]:.3f}")
    return {"max_abs_err": max_abs, **times}


def check_proj_gated_int8(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    print("kernel 6, int8 out-projection + gated residual on the int8 core (exact: the same "
          "int8 values, an exact product and the same fp32 epilogue)")
    a, h = (torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    gate = _uni(gen, dev, (1024,), 1.0)
    qp = _int8_linear(gen, dev, 1024, 1024)
    max_abs, _ = compare(f"proj_gated_residual_int8 main m=3072 d=1024 (tile width "
                         f"{tile_width(3072, 1024, 1024)})",
                         fl.proj_gated_residual_int8(a, h, gate, qp),
                         fl.proj_gated_residual_int8_reference(a, h, gate, qp), INT8_REL,
                         exact=True)
    # ragged rows with a zero and an outlier row; din = 2048 (the FF width)
    qp2 = _int8_linear(gen, dev, 1024, 2048)
    for m, din, w in ((1000, 1024, qp), (1, 1024, qp), (127, 1024, qp), (1000, 2048, qp2),
                      (127, 2048, qp2)):
        ar = _edge_rows(gen, dev, max(m, 8), din)[:m][None]
        rows = "zero+outlier rows" if m > 7 else "rows"
        compare(f"proj_gated_residual_int8 m={m} din={din} {rows} (tile width "
                f"{tile_width(m, 1024, 1024)})",
                fl.proj_gated_residual_int8(ar, h[:1, :m], gate, w),
                fl.proj_gated_residual_int8_reference(ar, h[:1, :m], gate, w), INT8_REL,
                exact=True)
    times = _timed(lambda: fl.proj_gated_residual_int8(a, h, gate, qp),
                   lambda: fl.proj_gated_residual_int8_reference(a, h, gate, qp),
                   2.0 * 3072 * 1024 * 1024, (a, h, gate, qp, h))
    # both tile widths, forced, beside gemm_tile_n's pick (at m = 3072 the
    # 256-wide tiles are 96 on 132 SMs, the 128-wide 192)
    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream
    a2, h2 = a.reshape(3072, 1024), h.reshape(3072, 1024)
    want = fl.proj_gated_residual_int8_reference(a2, h2, gate, qp)
    aq, as_ = torch.empty((3072, 1024), dtype=torch.int8, device=dev), torch.empty(3072, device=dev)
    out, ms = torch.empty_like(want), {}
    for bn in (128, 256):
        def forced(bn=bn):
            cuda_build.check(lib.f5_proj_gated_int8_width(
                a2.data_ptr(), h2.data_ptr(), gate.data_ptr(), qp["w_int8"].data_ptr(),
                qp["w_scale"].data_ptr(), qp["b"].data_ptr(), aq.data_ptr(), as_.data_ptr(),
                out.data_ptr(), 3072, 1024, 1024, 0, bn, dev.index, stream),
                "proj_gated_int8_width")
        out.zero_()
        forced()
        compare(f"kernel 6 at tile width {bn}, m=3072", out, want, INT8_REL, exact=True)
        ms[bn] = cuda_time_ms(forced)
    print(f"  kernel 6 tile widths at m=3072 (picked: {tile_width(3072, 1024, 1024)}): 128 -> "
          f"{ms[128]:.4f} ms, 256 -> {ms[256]:.4f} ms, ratio {ms[128] / ms[256]:.3f}")
    return {"max_abs_err": max_abs, **times}


def check_ff_int8(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import ff_block as fb

    print(f"kernel 4, int8 FF half-block (rel bound {INT8_REL:.0e}: tie flips of the fp32 "
          "LN and GELU outputs; z quantized from fp32 on both sides)")
    h = torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
    sc, sh, gate = (_uni(gen, dev, (1024,), bound) for bound in (0.3, 0.3, 1.0))
    qp_in, qp_out = _int8_linear(gen, dev, 2048, 1024), _int8_linear(gen, dev, 1024, 2048)
    args = (sc, sh, gate, qp_in, qp_out)
    max_abs, _ = compare(f"ff_block_int8 main m=3072 d=1024 dff=2048 (tile widths "
                         f"{tile_width(3072, 2048, 2048)}, {tile_width(3072, 1024, 1024)})",
                         fb.ff_block_fused_int8(h, *args), fb.ff_block_int8_reference(h, *args),
                         INT8_REL)
    # ragged rows with a zero and an outlier row at the main widths; 65 rows
    # (128-wide tiles by the waves); dff = 1152 (128-wide tiles only, and a
    # z row pass that is no power of two)
    for m, d, dff in ((1000, 1024, 2048), (65, 1024, 2048), (1000, 1024, 1152)):
        hr = _edge_rows(gen, dev, m, d)[None]
        qi, qo = (qp_in, qp_out) if dff == 2048 else (_int8_linear(gen, dev, dff, d),
                                                      _int8_linear(gen, dev, d, dff))
        for label, shift in (("", sh), (", sh = 0 (zero y row)", torch.zeros_like(sh))):
            rargs = (sc, shift, gate, qi, qo)
            compare(f"ff_block_int8 m={m} d={d} dff={dff} zero+outlier rows{label} (tile widths "
                    f"{tile_width(m, dff, dff)}, {tile_width(m, d, d)})",
                    fb.ff_block_fused_int8(hr, *rargs), fb.ff_block_int8_reference(hr, *rargs),
                    INT8_REL)
    times = _timed(lambda: fb.ff_block_fused_int8(h, *args),
                   lambda: fb.ff_block_int8_reference(h, *args), 4.0 * 3072 * 1024 * 2048,
                   (h, args, h))
    # each product's tile width, forced: (first, second) product; at m = 1000
    # every width is one wave, so the ratios are the tile costs
    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream
    for m in (3072, 1000):
        hm = h.reshape(-1, 1024)[:m].contiguous()
        want = fb.ff_block_int8_reference(hm, *args)
        yq, zq = (torch.empty((m, k), dtype=torch.int8, device=dev) for k in (1024, 2048))
        ys, zs = torch.empty(m, device=dev), torch.empty(m, device=dev)
        z, out, ms = torch.empty((m, 2048), device=dev), torch.empty_like(want), {}
        for bns in ((128, 128), (128, 256), (256, 128), (256, 256)):
            def forced(bns=bns):
                cuda_build.check(lib.f5_ff_block_int8_widths(
                    hm.data_ptr(), sc.data_ptr(), sh.data_ptr(), gate.data_ptr(),
                    *(qp_in[k].data_ptr() for k in ("w_int8", "w_scale", "b")),
                    *(qp_out[k].data_ptr() for k in ("w_int8", "w_scale", "b")),
                    yq.data_ptr(), ys.data_ptr(), z.data_ptr(), zq.data_ptr(), zs.data_ptr(),
                    out.data_ptr(), m, 1024, 2048, 1e-6, 0, *bns, dev.index, stream),
                    "ff_block_int8_widths")
            out.zero_()
            forced()
            compare(f"kernel 4 at tile widths {bns}, m={m}", out, want, INT8_REL)
            ms[bns] = cuda_time_ms(forced)
        print(f"  kernel 4 tile widths at m={m} (picked: {tile_width(m, 2048, 2048)}, "
              f"{tile_width(m, 1024, 1024)}): " + ", ".join(
                  f"{bns} -> {t:.4f} ms" for bns, t in ms.items()))
    return {"max_abs_err": max_abs, **times}


def check_int8_fp32_rows(gen, dev) -> None:
    """Kernels 4, 5, 6 and 9 on fp32 rows (an fp32 model with int8 weights,
    as the JAX kernels run it: they read their rows as fp32 and write the
    input's dtype), with fp32 vectors, against their plain versions at the
    main shape and at ragged edges, and timed (the bf16 forms' times are their own checks'). 6 and 9
    without GELU must be exact (the same int8 values, an exact product, the
    same fp32 epilogue and no rounding after it); 4 and 5 within
    INT8_F32_REL (tie flips of the fp32 LN and GELU outputs), and the plain
    output rounded through bf16 (the fault of an epilogue with a bf16 step)
    must fail that bound. A mix of fp32 rows and bf16 vectors raises
    TypeError."""
    import torch

    from korean_f5_tts_tpu_torch.ops import ff_block as fb
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl
    from korean_f5_tts_tpu_torch.ops import qmatmul as qm

    print("kernels 4, 5, 6, 9 on fp32 rows (fp32 vectors and output; the products int8)")

    def f32_linear(n, k):
        qp = _int8_linear(gen, dev, n, k)
        return {**qp, "b": qp["b"].float()}

    h, a = (torch.randn((2, 1536, 1024), generator=gen, device=dev) for _ in range(2))
    sc, sh, gate = (_uni(gen, dev, (1024,), bound).float() for bound in (0.3, 0.3, 1.0))
    qp_in, qp_out = f32_linear(2048, 1024), f32_linear(1024, 2048)
    qps = [f32_linear(1024, 1024) for _ in range(3)]
    x = a.reshape(3072, 1024)
    cases = {
        "4": (lambda hh: fb.ff_block_fused_int8(hh, sc, sh, gate, qp_in, qp_out),
              lambda hh: fb.ff_block_int8_reference(hh, sc, sh, gate, qp_in, qp_out), False),
        "5": (lambda hh: fl.ln_mod_matmul_int8(hh, sc, sh, qps),
              lambda hh: fl.ln_mod_matmul_int8_reference(hh, sc, sh, qps), False),
        "6": (lambda hh: fl.proj_gated_residual_int8(hh, hh, gate, qps[0]),
              lambda hh: fl.proj_gated_residual_int8_reference(hh, hh, gate, qps[0]), True),
        "9": (lambda hh: qm.qmatmul(hh.reshape(-1, 1024), qps[1]["w_int8"], qps[1]["w_scale"],
                                    qps[1]["b"]),
              lambda hh: qm.qmatmul_reference(hh.reshape(-1, 1024), qps[1]["w_int8"],
                                              qps[1]["w_scale"], qps[1]["b"]), True),
        "9 + gelu_tanh": (
            lambda hh: qm.qmatmul(hh.reshape(-1, 1024), qps[1]["w_int8"], qps[1]["w_scale"],
                                  None, "gelu_tanh"),
            lambda hh: qm.qmatmul_reference(hh.reshape(-1, 1024), qps[1]["w_int8"],
                                            qps[1]["w_scale"], None, "gelu_tanh"), False),
    }
    edge = _edge_rows(gen, dev, 1000, 1024).float()[None]
    for name, (fn, plain, exact) in cases.items():
        for label, hh in (("main m=3072", h), ("m=1000 zero+outlier rows", edge),
                          ("m=1", h[:1, :1])):
            got, want = fn(hh), plain(hh)
            if got.dtype != torch.float32:
                fail(f"kernel {name} on fp32 rows returned {got.dtype}")
            compare(f"kernel {name} fp32 rows {label}", got, want, INT8_F32_REL, exact=exact)
            control = _rel(want.bfloat16(), want)
            print(f"    control: the plain output through bf16 reads rel {control:.3e} "
                  f"(must fail {INT8_F32_REL:.0e})")
            if control <= INT8_F32_REL:
                fail(f"kernel {name} fp32 rows {label}: the bound does not catch a bf16 step")
    try:  # a mix of fp32 rows and bf16 vectors is refused, as kernel B refuses one
        fl.ln_mod_matmul_int8(h, sc.bfloat16(), sh.bfloat16(), qps)
    except TypeError:
        pass
    else:
        fail("kernel 5 took fp32 rows with bf16 vectors")
    for name, (fn, _, _) in cases.items():
        if name == "9 + gelu_tanh":
            continue
        ms = cuda_time_ms(lambda: fn(h if name != "9" else x))
        print(f"  kernel {name} on fp32 rows at the main shape: {ms:.4f} ms")


# the tiles' edges of kernels 10, 11 and 13 (10: 192 query rows, 128-key
# tiles; 11: 128 query rows, 128-key tiles; 13: 128 keys, 64-query tiles; the
# fp32 forms: 64 x 64): (n, kv_lens, keys past kv_len at +-past)
TRAIN_EDGES = (
    (1, [1], None),
    (63, [0, 1, 63], None),
    (64, [0, 1, 63, 64], None),
    (65, [1, 64, 65], None),
    (100, [0, 1, 63, 64, 65, 100], None),
    (127, [1, 127], None),
    (128, [0, 1, 127, 128], None),
    (129, [1, 63, 64, 65, 127, 128, 129], None),
    (200, [1, 63, 64, 65, 127, 128, 129, 200], None),
    (301, [0, 1, 63, 64, 65, 127, 128, 129, 301], None),
    (301, [1, 64, 129, 200, 300, 301], 1e4),
)


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def tf32_control(label: str, plain, want, rel_bound: float, base=None) -> float:
    """The plain version with both of PyTorch's TF32 switches on (each fp32
    matmul one TF32 product) against `want`, the same with them off: it must
    fail `rel_bound`, or the bound would not tell a TF32 product from an fp32
    one. base: the residual h of a gated form (B, 8), taken off both sides,
    so the control reads the branch the products make."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got = plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    r = _rel(got, want) if base is None else _rel(got - base, want - base)
    whole = "" if base is None else f" (on the whole output {_rel(got, want):.3e}, not held)"
    print(f"  control: {label}'s plain version with TF32 on reads rel {r:.3e}"
          f"{'' if base is None else ' on the gated branch (out - h)'} (must fail "
          f"{rel_bound:.0e}){whole}")
    if r <= rel_bound:
        fail(f"{label}: the TF32 control passes rel {rel_bound:.0e}, which would not tell a TF32 "
             "product from an fp32 one")
    return r


def efficient_f32(q, k, v, length: int):
    """PyTorch's memory-efficient attention (exact fp32 with TF32 off; its
    flash and cuDNN backends take no fp32) of fp32 q [H, n, 64] over the
    first `length` keys of k, v [H, n, 64]."""
    import torch

    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q[None], k[None, :, :length], v[None, :, :length], None, False, 0.0, False,
        scale=q.shape[-1] ** -0.5)[0][0]


def efficient_f32_sliced(q, k, v, kv):
    """The one PyTorch call for kernel A's function on fp32 operands when
    every folded head has the same kv_len: efficient_f32 on the keys sliced
    to that length, as sdpa_sliced for the bf16 form."""
    lens = kv.tolist()
    if len(set(lens)) != 1:
        raise ValueError("efficient_f32_sliced: the kv_lens differ; the sliced call would "
                         "compute another function")
    return lambda: efficient_f32(q, k, v, lens[0])


def check_train_attention(gen, dev) -> dict[str, dict]:
    """Kernels 10-13 at the training shape (b 8 x 16 heads = H 128, n 1280,
    d 64), at a ragged n with mixed kv_lens and at the edges of the tiles of
    kernels 10 (192 query rows, 128-key tiles) and 13 (128 keys a block,
    64-query tiles): n 100, 200, 301 (301: an [H, n] fp32 row of lse or D
    starts at no 16-byte boundary), kv_len 0, 1, 63-65, 127-129 and n, keys
    past kv_len at +-1e4. A head with kv_len 0 is held to the kernels'
    convention directly (zero o, lse 0, zero dk and dv), not to the plain o,
    which averages every key there (MASK_VALUE is finite). Kernel 10 runs
    twice on the same inputs, as the step's remat recompute does, and must
    give the same bits. Then the autograd Function against autograd of the
    plain attention."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    def inputs(H, n, lens, past=None):
        q, k, v, do = (torch.randn((H, n, 64), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        if past is not None:  # keys past kv_len that win every max unless masked first
            for h, L in enumerate(lens):
                k[h, L:] = past * q[h].float().mean(0).sign().to(torch.bfloat16)
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        o, lse = fp.prefix_attention_lse_reference(q, k, v, kv)
        o[kv == 0] = 0  # no valid key: zeros (the kernels'), not the plain uniform mean
        dvec = (do.float() * o.float()).sum(-1)
        return q, k, v, do, kv, o, lse, dvec

    def case(label, H, n, lens, past=None):
        q, k, v, do, kv, o, lse, dvec = inputs(H, n, lens, past)
        o10, lse10 = fp.flash_prefix_folded_lse(q, k, v, kv)
        again = fp.flash_prefix_folded_lse(q, k, v, kv)
        err = {"flash_prefix_lse": compare(f"kernel 10 o {label}", o10, o, 1e-2)[0]}
        compare(f"kernel 10 lse {label}", lse10, lse, 1e-5)
        if not (torch.equal(again[0], o10) and torch.equal(again[1], lse10)):
            fail(f"kernel 10 {label}: a second launch on the same inputs gave other bits")
        zero = n == 1  # dq and dk are identically zero there (compare's note)
        dq11 = fp.flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv)
        err["flash_prefix_dq_lsein"] = compare(
            f"kernel 11 dq {label}", dq11,
            fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv), 1e-2, zero=zero)[0]
        dq12, lse12 = fp.flash_prefix_dq(q, k, v, do, dvec, kv)
        dq_p, _ = fp.flash_prefix_dq_reference(q, k, v, do, dvec, kv)
        err["flash_prefix_dq"] = compare(f"kernel 12 dq {label}", dq12, dq_p, 1e-2,
                                         zero=zero)[0]
        compare(f"kernel 12 lse {label}", lse12, lse, 1e-5)
        dk, dv = fp.flash_prefix_dkv(q, k, v, do, dvec, lse, kv)
        dk_p, dv_p = fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv)
        err["flash_prefix_dkv"] = max(compare(f"kernel 13 dk {label}", dk, dk_p, 1e-2,
                                              zero=zero)[0],
                                      compare(f"kernel 13 dv {label}", dv, dv_p, 1e-2)[0])
        torch.cuda.synchronize()
        zero = kv == 0
        if zero.any():
            worst = max(t[zero].abs().max().item() for t in (o10, lse10, dk, dv))
            print(f"  kv_len 0 heads {label}: max |o|, |lse|, |dk|, |dv| there {worst:.1e} "
                  f"(must be 0) {'ok' if worst == 0 else 'FAIL'}")
            if worst != 0:
                fail(f"kernels 10/13 {label}: a head with kv_len 0 is not zero o, lse 0 and "
                     "zero dk, dv")
        return err, (q, k, v, do, kv, lse, dvec)

    print("kernels 10-13, training attention (bf16 in, rel bound 1e-2 for o and the "
          "gradients: P and dS round to bf16 before their products in the kernels; lse "
          "fp32, rel bound 1e-5); 10 on the attention core, 11 and 13 on the attention "
          "backward core, 12 on it too (11's kernel recomputing the lse)")
    errs, (q, k, v, do, kv, lse, dvec) = case("main H=128 n=1280 d=64 kv=n", 128, 1280,
                                              [1280] * 128)
    mixed = torch.randint(1, 1201, (16,), generator=gen, device=dev).tolist()
    case(f"ragged H=16 n=1200 mixed kv={mixed}", 16, 1200, mixed)
    for n, lens, past in TRAIN_EDGES:
        case(f"edge n={n} kv={lens}{' keys past kv_len at +-1e4' if past else ''}", len(lens),
             n, lens, past)

    # the Function against autograd of the plain attention: the plain path
    # rounds P, dP and dS to bf16 at other points, so relative L2 only
    b, h, n = 8, 16, 1280
    qkv = [t.reshape(b, h, n, 64) for t in (q, k, v)]
    lens = torch.full((b,), n, dtype=torch.int32, device=dev)
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        out = fp.flash_prefix_attention(*leaves, lens, kernels=kernels)
        grads.append(torch.autograd.grad(out, leaves, do.reshape(b, h, n, 64)))
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        err = _rel(got, want)
        print(f"  Function {name} vs autograd of the plain attention: rel_err {err:.3e} "
              f"(bound 2e-2)")
        if not torch.isfinite(got).all() or err > 2e-2:
            fail(f"the attention Function's {name} disagrees with the plain backward")

    timed = {
        "flash_prefix_lse": (lambda: fp.flash_prefix_folded_lse(q, k, v, kv),
                             lambda: fp.prefix_attention_lse_reference(q, k, v, kv), 4),
        "flash_prefix_dq_lsein": (
            lambda: fp.flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv),
            lambda: fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv), 6),
        "flash_prefix_dq": (lambda: fp.flash_prefix_dq(q, k, v, do, dvec, kv),
                            lambda: fp.flash_prefix_dq_reference(q, k, v, do, dvec, kv), 6),
        "flash_prefix_dkv": (lambda: fp.flash_prefix_dkv(q, k, v, do, dvec, lse, kv),
                             lambda: fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv),
                             8),
    }
    # inputs read once, outputs written once (o, dq, dk, dv are shaped like q;
    # lse and D like dvec)
    io = {"flash_prefix_lse": (q, k, v, kv, q, lse),
          "flash_prefix_dq_lsein": (q, k, v, do, dvec, lse, kv, q),
          "flash_prefix_dq": (q, k, v, do, dvec, kv, q, lse),
          "flash_prefix_dkv": (q, k, v, do, dvec, lse, kv, k, v)}
    out = {}
    for name, (fn, plain, products) in timed.items():
        ms, plain_ms = cuda_time_ms(fn), cuda_time_ms(plain)
        flop = products * 128 * 1280 * 1280 * 64
        print(f"  {name} at the main shape: kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms")
        out[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     **bound(flop, io[name])}
    lib_fwd, lib_bwd = flash_library_times(q, k, v, do, kv, lse, dvec)
    out["flash_prefix_lse"]["library_ms"] = lib_fwd
    out["flash_prefix_dkv"]["library_ms"] = lib_bwd  # 11 + 13 together
    both = out["flash_prefix_dq_lsein"]["ms"] + out["flash_prefix_dkv"]["ms"]
    print(f"  11 + 13 {both:.4f} ms against the library backward {lib_bwd:.4f} ms: "
          f"{both / lib_bwd:.2f}x")
    return out


def check_train_attention_f32(gen, dev) -> dict[str, dict]:
    """The fp32 forms of kernels 10-13 (split 3xTF32 products on the tensor
    cores) at the training shape and at the cores' edges
    (TRAIN_EDGES) against their plain versions, with both of PyTorch's TF32
    switches off wherever a plain version runs: o and lse within
    F32_ATTN_REL, dq, dk, dv within F32_GRAD_REL (relative L2). A control:
    the plain versions with TF32 on (a single TF32 product) must fail those
    bounds. A head with kv_len 0 is held to zero o, lse 0 and zero
    gradients. Times with the bound at the 3xTF32 rate and at the FFMA rate,
    and the library yardstick: PyTorch's memory-efficient attention on fp32
    (forward with its logsumexp, and its backward), its error against the
    fp32 plain version printed beside its time; 10 fp32 must beat the
    library forward."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    def tf32_off():
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail("a plain fp32 version would run with TF32 on")

    def inputs(H, n, lens, past=None):
        q, k, v, do = (torch.randn((H, n, 64), generator=gen, device=dev) for _ in range(4))
        if past is not None:
            for h, L in enumerate(lens):
                k[h, L:] = past * q[h].mean(0).sign()
        return q, k, v, do, torch.as_tensor(lens, dtype=torch.int32, device=dev)

    def plain(q, k, v, do, kv):
        o, lse = fp.prefix_attention_lse_reference(q, k, v, kv)
        o[kv == 0] = 0  # no valid key: zeros (the kernels'), not the plain uniform mean
        dvec = (do * o).sum(-1)
        dq = fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv)
        dk, dv = fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv)
        return o, lse, dvec, dq, dk, dv

    def case(label, H, n, lens, past=None):
        q, k, v, do, kv = inputs(H, n, lens, past)
        tf32_off()
        o, lse, dvec, dq_p, dk_p, dv_p = plain(q, k, v, do, kv)
        o10, lse10 = fp.flash_prefix_folded_lse(q, k, v, kv)
        err = {"flash_prefix_lse_f32": compare(f"kernel 10 fp32 o {label}", o10, o,
                                               F32_ATTN_REL)[0]}
        compare(f"kernel 10 fp32 lse {label}", lse10, lse, F32_ATTN_REL)
        zero = n == 1  # dq and dk are identically zero there (compare's note)
        dq11 = fp.flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv)
        err["flash_prefix_dq_lsein_f32"] = compare(f"kernel 11 fp32 dq {label}", dq11, dq_p,
                                                   F32_GRAD_REL, zero=zero)[0]
        dq12, lse12 = fp.flash_prefix_dq(q, k, v, do, dvec, kv)
        err["flash_prefix_dq_f32"] = compare(f"kernel 12 fp32 dq {label}", dq12, dq_p,
                                             F32_GRAD_REL, zero=zero)[0]
        compare(f"kernel 12 fp32 lse {label}", lse12, lse, F32_ATTN_REL)
        dk, dv = fp.flash_prefix_dkv(q, k, v, do, dvec, lse, kv)
        err["flash_prefix_dkv_f32"] = max(
            compare(f"kernel 13 fp32 dk {label}", dk, dk_p, F32_GRAD_REL, zero=zero)[0],
            compare(f"kernel 13 fp32 dv {label}", dv, dv_p, F32_GRAD_REL)[0])
        torch.cuda.synchronize()
        zero = kv == 0
        if zero.any():
            worst = max(t[zero].abs().max().item() for t in (o10, lse10, dq11, dq12, dk, dv))
            if worst != 0:
                fail(f"the fp32 forms of 10-13 {label}: a head with kv_len 0 is not zero")
        return err, (q, k, v, do, kv, o, lse, dvec, dq_p, dk_p, dv_p)

    print(f"the fp32 forms of kernels 10-13 (3xTF32 on the tensor cores; rel bound "
          f"{F32_ATTN_REL:.0e} for o and lse, {F32_GRAD_REL:.0e} for dq, dk, dv: fp32 accuracy)")
    errs, main = case("main H=128 n=1280 d=64 kv=n", 128, 1280, [1280] * 128)
    q, k, v, do, kv, o, lse, dvec, dq_p, dk_p, dv_p = main
    mixed = torch.randint(1, 1201, (16,), generator=gen, device=dev).tolist()
    case(f"ragged H=16 n=1200 mixed kv={mixed}", 16, 1200, mixed)
    for n, lens, past in TRAIN_EDGES:
        case(f"edge n={n} kv={lens}{' keys past kv_len at +-1e4' if past else ''}", len(lens),
             n, lens, past)

    # the control: the same plain versions with TF32 on fail the bounds
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        o_t, lse_t, _, dq_t, dk_t, dv_t = plain(q, k, v, do, kv)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctl = {"o": (_rel(o_t, o), F32_ATTN_REL), "dq": (_rel(dq_t, dq_p), F32_GRAD_REL),
           "dk": (_rel(dk_t, dk_p), F32_GRAD_REL), "dv": (_rel(dv_t, dv_p), F32_GRAD_REL)}
    print("  control, the plain versions with TF32 on against TF32 off at the main shape: "
          + ", ".join(f"{nm} {r:.3e} (bound {bd:.0e})" for nm, (r, bd) in ctl.items())
          + f", lse {_rel(lse_t, lse):.3e}")
    if any(r <= bd for r, bd in ctl.values()):
        fail("the TF32 control passes the fp32 bounds: they would not tell TF32 from fp32")

    train = (q, k, v, do, dvec, lse, kv)
    timed = {
        "flash_prefix_lse_f32": (lambda: fp.flash_prefix_folded_lse(q, k, v, kv),
                                 lambda: fp.prefix_attention_lse_reference(q, k, v, kv), 4,
                                 (q, k, v, kv, q, lse)),
        "flash_prefix_dq_lsein_f32": (
            lambda: fp.flash_prefix_dq_lsein(*train),
            lambda: fp.flash_prefix_dq_lsein_reference(*train), 6, (*train, q)),
        "flash_prefix_dq_f32": (lambda: fp.flash_prefix_dq(q, k, v, do, dvec, kv),
                                lambda: fp.flash_prefix_dq_reference(q, k, v, do, dvec, kv), 6,
                                (q, k, v, do, dvec, kv, q, lse)),
        "flash_prefix_dkv_f32": (lambda: fp.flash_prefix_dkv(*train),
                                 lambda: fp.flash_prefix_dkv_reference(*train), 8,
                                 (*train, k, v)),
    }
    out = {}
    for name, (fn, plain_fn, products, io) in timed.items():
        print(f"  {name}:")
        out[name] = {"max_abs_err": errs[name],
                     **_timed(fn, plain_fn, products * 128 * 1280 * 1280 * 64, io, kind="fp32")}

    # the library yardstick on the same fp32 operands (every kv_len = n: no mask)
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    fwd = lambda: aten._scaled_dot_product_efficient_attention(q4, k4, v4, None, True, 0.0,
                                                               False, scale=0.125)
    lo, llse = fwd()[:2]
    print(f"  library: aten._scaled_dot_product_efficient_attention (fp32, with its "
          f"logsumexp): o rel {_rel(lo[0], o):.3e}, lse * log2(e) rel "
          f"{_rel(llse[0, :, :1280] * fp.LOG2E, lse):.3e} to the fp32 plain version")
    out["flash_prefix_lse_f32"]["library_ms"] = cuda_time_ms(fwd)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=0.125)
    bwd = lambda: torch.autograd.grad(lib_out, leaves, do4, retain_graph=True)
    ldq, ldk, ldv = bwd()
    print(f"  library backward (its autograd): dq rel {_rel(ldq[0], dq_p):.3e}, dk rel "
          f"{_rel(ldk[0], dk_p):.3e}, dv rel {_rel(ldv[0], dv_p):.3e} to the fp32 plain version")
    out["flash_prefix_dkv_f32"]["library_ms"] = cuda_time_ms(bwd)  # 11 + 13 together
    both = out["flash_prefix_dq_lsein_f32"]["ms"] + out["flash_prefix_dkv_f32"]["ms"]
    lib_bwd = out["flash_prefix_dkv_f32"]["library_ms"]
    fwd32 = out["flash_prefix_lse_f32"]
    print(f"  library: forward {fwd32['library_ms']:.4f} ms (10 fp32 {fwd32['ms']:.4f}: "
          f"{fwd32['ms'] / fwd32['library_ms']:.2f}x the library's time), backward "
          f"{lib_bwd:.4f} ms (11 + 13 fp32 {both:.4f}: {both / lib_bwd:.2f}x)")
    if fwd32["ms"] >= fwd32["library_ms"]:
        fail("kernel 10 fp32 is slower than the library's fp32 attention forward")
    for name in ("flash_prefix_lse_f32", "flash_prefix_dq_lsein_f32", "flash_prefix_dkv_f32"):
        r = out[name]
        print(f"  {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms at the 3xTF32 rate "
              f"({r['bound_ms'] / r['ms']:.3f} of the time), {r['ffma_bound_ms']:.4f} ms at the "
              f"FFMA rate ({r['ffma_bound_ms'] / r['ms']:.3f})")
    del leaves, lib_out
    return out


def flash_library_times(q, k, v, do, kv, lse, dvec) -> tuple[float, float]:
    """The library yardsticks of the training attention at its main shape
    (every kv_len = n, so the keys need no slicing): PyTorch's flash
    attention forward, which returns the output and the natural-log
    logsumexp in one call (kernel 10's function; its lse times log2(e) is
    kernel 10's base-2 lse), and its backward, which returns dq, dk and dv in
    one call (kernels 11 and 13 together; 12 has none). Each is held against
    the plain versions before it is timed."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    if len(set(kv.tolist())) != 1 or kv[0].item() != q.shape[1]:
        fail("flash_library_times: the yardstick needs every kv_len = n")
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    aten = torch.ops.aten
    fwd = lambda: aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False, False,
                                                            scale=scale)
    res = fwd()
    o, lse_nat = res[0], res[1]
    o_p, lse_p = fp.prefix_attention_lse_reference(q, k, v, kv)
    compare("library flash forward o (kernel 10's function)", o[0], o_p, 1e-2)
    compare("library flash forward lse * log2(e)", lse_nat[0] * fp.LOG2E, lse_p, 1e-5)
    fwd_ms = cuda_time_ms(fwd)
    bwd = lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o, lse_nat, res[2], res[3], res[4], res[5], 0.0, False, res[6],
        res[7], scale=scale)
    dq, dk, dv = bwd()
    compare("library flash backward dq (kernel 11's function)", dq[0],
            fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv), 1e-2)
    dk_p, dv_p = fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv)
    compare("library flash backward dk (kernel 13's function)", dk[0], dk_p, 1e-2)
    compare("library flash backward dv (kernel 13's function)", dv[0], dv_p, 1e-2)
    bwd_ms = cuda_time_ms(bwd)
    print(f"  library: aten._scaled_dot_product_flash_attention {fwd_ms:.4f} ms (kernel 10's "
          f"yardstick); its backward {bwd_ms:.4f} ms (kernels 11 + 13 together)")
    return fwd_ms, bwd_ms


# kernel 14's quantization error against kernel A: the share of the valid
# elements that may lie past the JAX package's max bound 3e-2 (set at 28x the
# one element of 2.8 M read at the main shape, PERF.md section 6), and
# the bound no element may pass (twice 3e-2)
QUANT_TAIL, QUANT_MAX = 1e-5, 6e-2


def check_attention_int8(gen, dev) -> dict[str, dict]:
    """Kernel 14 in both modes ("qkpv": int8 q.k^T and p.v; "qk": int8 q.k^T,
    bf16 p.v) on the int8 form of the attention core, and its quantization
    pass (one kernel, csrc/quant_heads.cu).

    The pass is held to its plain version (_quantize_qkv, _v8_kernel_layout)
    to the bit: q8, k8, v8 in the kernel's layout, c and sv. Kernel 14 is
    held to its plain version at its default key chunk (I8_KEY_CHUNK, 512,
    the JAX default bkv) at the attention core's edges (n 1, 127-129,
    191-193, 1000, 1536; kv_len 0, 1, 127-129, n; heads 2 and 16; B 1-3),
    at the chunk's (n 640 and 1536, kv_len inside the last chunk, on a chunk
    boundary and at n), and with K and V rows past kv_len at +-1e4 (masked
    keys must not reach the output); at the main shape, in both modes, it is
    closer to the plain version at the chunk than at the 128-key tile by a
    factor 4 (chunk_check). Its quantization error
    against kernel A on the same bf16 inputs is held where the rows past
    kv_len are ordinary values: at +-1e4 the per-head amax is 1e4 by the
    function's own definition (the JAX package's too), and those cases hold
    the kernel to its plain version only.

    The quantization error's bounds are the JAX package's test of its kernel
    (tests/test_flash_prefix.py: max 0.03, mean 0.005 over the valid rows),
    stated there at 2 x 2 heads of 256 keys. Over the 2.8 M valid elements of
    the main shape the max is a tail statistic: it read 3.125e-2 on one
    element there (3.149e-2 for the plain int8 version against the plain
    bf16 one, PERF.md section 6). So the mean is held at 5e-3, no element
    may pass QUANT_MAX, and at most QUANT_TAIL of the valid elements
    (rounded down) may lie past 3e-2, or as many as the plain int8 version
    itself has past 3e-2 against the plain bf16 one on the same draw where
    that is more: the count is a statistic of the draw, and the function
    passes the fraction on about one draw in ten at the two smaller cases
    (scripts/int8_attn_tail.py, at the key chunk 64 of the mma.sync kernel
    as at 128). These bounds hold at the three cases where they were set
    (the main shape, n 1000 with kv_len 1 to 1000, n 300) and at each of
    the core's edges with ordinary values past kv_len where the fraction
    allows at least one element. At the other edges (fewer than 100,000
    valid elements) the kernel is held to its plain version and its error
    against A is printed beside the plain version's own (at n 1, 128
    elements, the function's mean can pass 5e-3)."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    # "qkpv": the products are exact integers on both sides; what can differ
    # is a p8 = rint(127 p) at a rounding tie (ex2.approx against torch.exp2,
    # the row sum in another order) and the last bf16 rounding. "qk": the
    # kernel sums bf16(p).v inside the tensor core across the tile, the plain
    # version in one fp32 matmul.
    rel_bounds = {"qkpv": 2e-3, "qk": 5e-3}

    pass_err = []  # the pass's largest difference from its plain version, per case

    def check_pass(label, q, k, v):
        """the pass against its plain version, both modes, to the bit"""
        err = 0.0
        for mode, pv_i8 in (("qkpv", True), ("qk", False)):
            got = fp.quantize_heads(q, k, v, pv_i8)
            q8, k8, vq, c, sv = fp._quantize_qkv(q, k, v, pv_i8)
            want = (q8, k8, fp._v8_kernel_layout(vq) if pv_i8 else vq, c, sv)
            for name, g, w in zip(("q8", "k8", "v8" if pv_i8 else "v", "c", "sv"), got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    fail(f"quantization pass {mode} {label}: {name} is {tuple(g.shape)} "
                         f"{g.dtype}, the plain version's {tuple(w.shape)} {w.dtype}")
                diff = (g.float() - w.float()).abs()
                err = max(err, diff.max().item() if diff.numel() else 0.0)
                if not torch.equal(g, w):
                    fail(f"quantization pass {mode} {label}: {name} differs from the plain "
                         f"version ({int((diff != 0).sum().item())} elements, max "
                         f"{diff.max().item():.3e})")
        print(f"  quantization pass {label}: q8, k8, v8 (kernel layout) / v, c, sv equal to the "
              f"plain version to the bit, both modes (max abs difference {err:.3e})")
        pass_err.append(err)

    def case(label, B, H, n, lens, past=0.0, views=False, quant_held=False):
        """both modes on [B, H, n, 64] inputs; returns qkpv's max abs error"""
        if views:  # the sampler's layout: q, k, v as head views of one qkv array
            qkv = torch.randn((B, n, 3 * H * 64), generator=gen, device=dev)
            if past:
                for i, length in enumerate(lens):
                    sign = torch.randint(0, 2, (n - length, 2 * H * 64), generator=gen,
                                         device=dev)
                    qkv[i, length:, H * 64:] = past * (2.0 * sign - 1)
            q, k, v = fp.qkv_unpack(qkv.to(torch.bfloat16), H)
        else:
            q, k, v = (torch.randn((B, H, n, 64), generator=gen, device=dev) for _ in range(3))
            for i, length in enumerate(lens if past else ()):
                for t in (k, v):
                    sign = torch.randint(0, 2, (H, n - length, 64), generator=gen, device=dev)
                    t[i, :, length:] = past * (2.0 * sign - 1)
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        check_pass(label, q, k, v)
        lens_h = kv.repeat_interleave(H)
        live = lens_h > 0
        fold = [t.reshape(B * H, n, 64).contiguous() for t in (q, k, v)]
        via_a = fp.flash_prefix_folded(*fold, lens_h)
        rows = (torch.arange(n, device=dev)[None, :, None] < lens_h[:, None, None])[live]
        valid = int(rows.sum().item()) * 64

        def quant_err(got, base):
            err = ((got.float() - base.float()).abs())[live] * rows
            return (err.max().item(), (err.sum() / max(valid, 1)).item(),
                    int((err > 3e-2).sum().item()))

        errs = {}
        for mode, pv_i8 in (("qkpv", True), ("qk", False)):
            got = fp.flash_prefix_attention_i8(q, k, v, kv, pv_i8=pv_i8).reshape(B * H, n, 64)
            want = fp.flash_prefix_i8_reference(q, k, v, lens_h, pv_i8=pv_i8)
            torch.cuda.synchronize()
            if (~live).any() and got[~live].abs().max().item() != 0:
                fail(f"flash_prefix_i8 {mode} {label}: a head with no valid key is not zero")
            if not live.any():
                continue
            errs[mode] = compare(f"flash_prefix_i8 {mode} {label}", got[live], want[live],
                                 rel_bounds[mode])[0]
            if past:
                continue
            e_max, e_mean, e_past = quant_err(got, via_a)
            p_max, p_mean, p_past = quant_err(want, fp.prefix_attention_reference(*fold, lens_h))
            tail = max(int(QUANT_TAIL * valid), p_past)
            held = "bound" if quant_held else "printed; held from 100,000 valid elements"
            print(f"    {mode} vs kernel A on the same bf16 inputs: max {e_max:.3e} ({held} "
                  f"{QUANT_MAX}), {e_past} of {valid} past 3e-2 ({held} {tail}: "
                  f"{int(QUANT_TAIL * valid)} by the fraction, or the plain version's count), "
                  f"mean {e_mean:.3e} ({held} 5e-3); the plain int8 version vs the plain bf16 "
                  f"one: max {p_max:.3e}, {p_past} past 3e-2, mean {p_mean:.3e}")
            if quant_held and (e_max > QUANT_MAX or e_past > tail or e_mean > 5e-3):
                fail(f"flash_prefix_i8 {mode} {label}: quantization error out of bounds")
        return errs.get("qkpv", 0.0), (q, k, v, kv)

    print("kernel 14, int8 prefix attention on the attention core's int8 form, and its "
          "quantization pass (rel bound 2e-3 for qkpv: exact integer products, p8 ties and the "
          "last bf16 rounding; 5e-3 for qk: bf16 p.v summed in the tensor core)")
    max_abs, (q, k, v, kv) = case("main B=2 heads=16 n=1536 kv=1376 (head views of qkv)", 2, 16,
                                  1536, [1376, 1376], views=True, quant_held=True)
    ragged = [1, 1000, 700, 64, 65, 999, 333, 128]
    case(f"ragged B=8 heads=1 n=1000 kv={ragged}", 8, 1, 1000, ragged, quant_held=True)
    case("B=4 heads=1 n=300 kv=[300, 1, 77, 129]", 4, 1, 300, [300, 1, 77, 129],
         quant_held=True)
    # the attention core's edges (QKV_EDGES: n around the 128-key tiles and the
    # 192-row blocks, kv_len 0, 1, 127-129, n, heads 2 and 16, B 1-3) and the
    # 512-key chunk's (I8_CHUNK_EDGES), with K and V past kv_len at +-1e4, and
    # again with ordinary values there
    for B, H, n, lens, _, past in QKV_EDGES + I8_CHUNK_EDGES:
        for p in ((past, 0.0) if past else (0.0,)):
            case(f"B={B} heads={H} n={n} kv={lens}{f' past=+-{p:g}' if p else ''}", B, H, n, lens,
                 past=p, views=B > 1,
                 quant_held=not p and int(QUANT_TAIL * H * 64 * sum(lens)) > 0)

    ops = 4.0 * 32 * 1536 * 1376 * 64  # every query row against this run's 1376 keys
    q8, k8, v8k, c, sv = fp.quantize_heads(q, k, v, True)
    _, _, vb, _, _ = fp.quantize_heads(q, k, v, False)
    lens_h = kv.repeat_interleave(16)
    out = fp.flash_prefix_folded_i8(q8, k8, v8k, c, sv, lens_h)
    v8 = fp._v8_natural_layout(v8k, 1536)
    print("  the chunk of kernel 14's running max at the main shape:")
    chunk_check("qkpv main", out, q8, k8, v8, c, sv, lens_h, True)
    chunk_check("qk main", fp.flash_prefix_folded_i8(q8, k8, vb, c, sv, lens_h, pv_i8=False),
                q8, k8, vb, c, sv, lens_h, False)
    ms = cuda_time_ms(lambda: fp.flash_prefix_folded_i8(q8, k8, v8k, c, sv, lens_h))
    ms_qk = cuda_time_ms(lambda: fp.flash_prefix_folded_i8(q8, k8, vb, c, sv, lens_h,
                                                           pv_i8=False))
    plain_ms = cuda_time_ms(lambda: fp._i8_attention_plain(q8, k8, v8, c, sv, lens_h, True,
                                                           fp.I8_KEY_CHUNK))
    quant_ms = cuda_time_ms(lambda: fp.quantize_heads(q, k, v, True))
    quant_qk_ms = cuda_time_ms(lambda: fp.quantize_heads(q, k, v, False))
    quant_plain_ms = cuda_time_ms(lambda: fp._v8_kernel_layout(fp._quantize_qkv(q, k, v,
                                                                                True)[2]))
    whole_ms = cuda_time_ms(lambda: fp.flash_prefix_attention_i8(q, k, v, kv))
    whole_qk_ms = cuda_time_ms(lambda: fp.flash_prefix_attention_i8(q, k, v, kv, pv_i8=False))
    fold = [t.reshape(32, 1536, 64).contiguous() for t in (q, k, v)]
    a_ms = cuda_time_ms(lambda: fp.flash_prefix_folded(*fold, lens_h))
    print(f"  time at main shape: kernel 14 qkpv {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), qk "
          f"{ms_qk:.4f} ms, plain (on quantized operands) {plain_ms:.4f} ms; the quantization "
          f"pass (one kernel) qkpv {quant_ms:.4f} ms, qk {quant_qk_ms:.4f} ms (its plain version "
          f"in torch ops {quant_plain_ms:.4f} ms); pass + kernel as sdpa calls them: qkpv "
          f"{whole_ms:.4f} ms, qk {whole_qk_ms:.4f} ms; kernel A on the bf16 inputs {a_ms:.4f} "
          f"ms: int8 attention takes {whole_ms / a_ms:.2f}x A's time (qkpv), "
          f"{whole_qk_ms / a_ms:.2f}x (qk); library: none")
    b = bound(ops, (q8, k8, v8k, c, sv, lens_h, out), kind="int8")
    print(f"  the bound is {b['bound_ms'] / ms:.3f} of the kernel's time")
    print("  the pass's bound (each input read once, each output written once):")
    bq = bound(0.0, (q, k, v, q8, k8, v8k, c, sv), kind="int8")
    print(f"  the bound is {bq['bound_ms'] / quant_ms:.3f} of the pass's time")
    return {"flash_prefix_i8": {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b},
            "flash_prefix_i8_quant": {"max_abs_err": max(pass_err), "ms": quant_ms,
                                      "plain_ms": quant_plain_ms, **bq}}


def _linear(gen, dev, n: int, k: int) -> dict:
    """A bf16 linear {w [n, k], b [n]}, uniform +-1/sqrt(k)."""
    return {"w": _uni(gen, dev, (n, k), k ** -0.5), "b": _uni(gen, dev, (n,), k ** -0.5)}


def _context(label: str, fn) -> float:
    ms = cuda_time_ms(fn)
    print(f"  for context, not a yardstick: {label} {ms:.4f} ms")
    return ms


def check_ln_mod(gen, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from korean_f5_tts_tpu_torch.models.modules import layernorm
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    print("kernel 7, LN + modulate + qkv product (bf16, rel bound 5e-3: same rounding "
          "points, fp32 sums in another order)")
    h = torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
    sc, sh = _uni(gen, dev, (1024,), 0.3), _uni(gen, dev, (1024,), 0.3)
    ps = [_linear(gen, dev, 1024, 1024) for _ in range(3)]
    got = fl.ln_mod_matmul(h, sc, sh, ps)
    max_abs, _ = compare("ln_mod_matmul main m=3072 d=1024 n=3x1024", got,
                         fl.ln_mod_matmul_reference(h, sc, sh, ps), 5e-3)
    for m, seg in ((1000, ps), (1000, ps[:1]), (65, ps[:2]), (1, ps)):
        hr = torch.randn((1, m, 1024), generator=gen, device=dev).to(torch.bfloat16)
        compare(f"ln_mod_matmul ragged m={m}, {len(seg)} linear(s)",
                fl.ln_mod_matmul(hr, sc, sh, seg), fl.ln_mod_matmul_reference(hr, sc, sh, seg),
                5e-3)
    times = _timed(lambda: fl.ln_mod_matmul(h, sc, sh, ps),
                   lambda: fl.ln_mod_matmul_reference(h, sc, sh, ps), 2.0 * 3072 * 1024 * 3072,
                   (h, sc, sh, ps, got), kind="bf16")

    def default_path():  # what attention() runs per block on the "default" path
        w = torch.cat([p["w"] for p in ps], dim=0)
        b = torch.cat([p["b"] for p in ps])
        return F.linear(layernorm({}, h) * (1 + sc) + sh, w, b)

    w_cat, b_cat = torch.cat([p["w"] for p in ps], dim=0), torch.cat([p["b"] for p in ps])
    composed = _context("the default path's layernorm + modulate + weight concat + F.linear",
                        default_path)
    _context("F.linear alone, [3072, 1024] x [3072, 1024]^T", lambda: F.linear(h, w_cat, b_cat))
    if times["ms"] > composed:
        fail(f"kernel 7 ({times['ms']:.4f} ms) is slower than the composition it replaces "
             f"({composed:.4f} ms)")
    return {"max_abs_err": max_abs, **times}


def check_proj_gated(gen, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    print("kernel 8, out-projection + gated residual (bf16, rel bound 5e-3: same rounding "
          "points, fp32 sums in another order)")
    a, h = (torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    gate = _uni(gen, dev, (1024,), 1.0)
    p = _linear(gen, dev, 1024, 1024)
    got = fl.proj_gated_residual(a, h, gate, p)
    max_abs, _ = compare("proj_gated_residual main m=3072 d=1024", got,
                         fl.proj_gated_residual_reference(a, h, gate, p), 5e-3)
    for m in (1000, 65, 1):
        compare(f"proj_gated_residual ragged m={m}",
                fl.proj_gated_residual(a[:1, :m].contiguous(), h[:1, :m].contiguous(), gate, p),
                fl.proj_gated_residual_reference(a[:1, :m], h[:1, :m], gate, p), 5e-3)
    times = _timed(lambda: fl.proj_gated_residual(a, h, gate, p),
                   lambda: fl.proj_gated_residual_reference(a, h, gate, p),
                   2.0 * 3072 * 1024 * 1024, (a, h, gate, p, got), kind="bf16")
    _context("the default path's F.linear + gated add",
             lambda: h + gate * F.linear(a, p["w"], p["b"]))
    _context("F.linear alone, [3072, 1024] x [1024, 1024]^T",
             lambda: F.linear(a, p["w"], p["b"]))
    # Both output tile widths of the product core, forced through the probe's
    # entry point: at m = 1000 either width is a single wave (64 or 32 tiles
    # on the card's SMs), so the ratio of the two times is the tile cost that
    # csrc/gemm_bf16.cuh:gemm_tile_n weighs waves with.
    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream
    for m in (3072, 1000):
        am, hm = a.reshape(-1, 1024)[:m].contiguous(), h.reshape(-1, 1024)[:m].contiguous()
        want, out, ms = fl.proj_gated_residual_reference(am, hm, gate, p), torch.empty_like(hm), {}
        for bn in (128, 256):
            def forced(bn=bn):
                cuda_build.check(lib.f5_probe_tile_width(
                    am.data_ptr(), hm.data_ptr(), gate.data_ptr(), p["w"].data_ptr(),
                    p["b"].data_ptr(), out.data_ptr(), m, 1024, 1024, bn, dev.index, stream),
                    "probe_tile_width")
            out.zero_()
            forced()
            compare(f"kernel 8's product at tile width {bn}, m={m}", out, want, 5e-3)
            ms[bn] = cuda_time_ms(forced)
        print(f"  tile widths at m={m}: 128 -> {ms[128]:.4f} ms, 256 -> {ms[256]:.4f} ms, "
              f"ratio {ms[128] / ms[256]:.3f}")
    return {"max_abs_err": max_abs, **times}


# kernel 19's edge cases: (B, heads, n, kv_lens, pe_attn_head, K and V rows
# past kv_len at +-this, 0 for random rows)
QKV_EDGES = (
    (1, 2, 1, [1], None, 0.0),
    (3, 2, 127, [0, 1, 127], 1, 1e4),
    (3, 16, 128, [127, 128, 1], None, 1e4),
    (2, 2, 129, [128, 129], 1, 1e4),
    (3, 2, 191, [129, 191, 0], None, 1e4),
    (2, 16, 192, [192, 191], 1, 1e4),
    (3, 2, 193, [193, 1, 129], None, 1e4),
    (2, 2, 1000, [0, 1000], 1, 1e4),
    (2, 16, 1536, [1376, 1536], None, 1e4),
)
# int8 attention's 512-key chunks (kernel 14 takes its running max per four
# tiles): several chunks, the last partial, kv_len inside the last chunk, on
# a chunk boundary and at n
I8_CHUNK_EDGES = (
    (3, 2, 640, [600, 512, 640], None, 1e4),
    (3, 2, 1536, [1376, 1024, 1536], None, 1e4),
)


def chunk_check(label: str, got, q8, k8, v, c, sv, lens_h, pv_i8: bool) -> None:
    """Kernel 14's output is the plain version at the 512-key chunk, not at
    the 128-key tile: its distance to the first is under a quarter of its
    distance to the second (the "qk" bound alone cannot tell them apart)."""
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    live = lens_h > 0
    e = {ck: _rel(got[live], fp._i8_attention_plain(q8, k8, v, c, sv, lens_h, pv_i8,
                                                    ck)[live].to(got.dtype))
         for ck in (fp.I8_KEY_CHUNK, fp.I8_KEY_TILE)}
    ok = e[fp.I8_KEY_CHUNK] * 4 < e[fp.I8_KEY_TILE]
    print(f"    {label}: rel to the plain version at chunk {fp.I8_KEY_CHUNK} "
          f"{e[fp.I8_KEY_CHUNK]:.3e}, at {fp.I8_KEY_TILE} {e[fp.I8_KEY_TILE]:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel 14 {label}: not the function at the 512-key chunk")


def check_rope_attention(gen, dev) -> dict[str, dict]:
    """Kernels 18 and 19 at the main shape (B 2 x 16 heads = H 32, n 1536,
    d 64, 1376 valid keys) and at ragged shapes and the attention core's
    edges, against their plain versions, against kernel A fed with
    torch-roped q, k, and against each other: 18 and 19 are one
    instantiation of the attention core's rope form over two layouts, so on
    the same values they must agree to the bit."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import apply_rope, rope_cos_sin
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    def tables(n):
        return tuple(torch.from_numpy(t).to(dev).to(torch.bfloat16) for t in rope_cos_sin(n, 64))

    def merge(o):
        B, H, n, d = o.shape
        return o.transpose(1, 2).reshape(B, n, H * d)

    def case(label, B, H, n, lens, pe):
        """Both kernels on the same values; returns their max abs errors."""
        qkv = torch.randn((B, n, 3 * H * 64), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.contiguous() for t in fp.qkv_unpack(qkv, H))
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        cos, sin = tables(n)
        got18 = fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin, pe)
        got19 = fp.flash_prefix_qkv_attention(qkv, kv, H, cos, sin, pe)
        torch.cuda.synchronize()
        live = [i for i, length in enumerate(lens) if length > 0]
        for i, length in enumerate(lens):
            # no valid key: the kernels give zeros (as the TPU kernel does), the
            # plain softmax a mean of v, so those items are held to zero instead
            if length == 0 and (got18[i].abs().max().item() or got19[i].abs().max().item()):
                fail(f"kernels 18/19 {label}: item {i} with no valid key is not zero")
        want = fp.flash_prefix_rope_reference(q[live], k[live], v[live], kv[live], cos, sin, pe)
        e18 = compare(f"kernel 18 {label}", got18[live], want, 1e-2)[0]
        e19 = compare(f"kernel 19 {label}", got19[live], merge(want), 1e-2)[0]
        compare(f"kernel 18 vs kernel 19 on the same values, {label}", merge(got18), got19, 1e-2,
                exact=True)
        # the same attention through kernel A on q, k roped by torch with the
        # kernels' rounding: the loops are one, so only rope rounding ties differ
        via_a = fp.flash_prefix_attention(fp.rope_reference(q[live], cos, sin, pe),
                                          fp.rope_reference(k[live], cos, sin, pe), v[live],
                                          kv[live])
        compare(f"kernel 18 vs kernel A on torch-roped q, k, {label}", got18[live], via_a, 5e-3)
        compare(f"kernel 19 vs kernel A on torch-roped q, k, {label}", got19[live], merge(via_a),
                5e-3)
        return (e18, e19), (qkv, q, k, v, kv, cos, sin, got18, got19)

    def case19(label, B, H, n, lens, pe, past):
        """Kernels 19 and 18 on inputs whose K and V rows past each item's
        kv_len hold +-past; 18 on the same values split into heads."""
        qkv = torch.randn((B, n, 3 * H * 64), generator=gen, device=dev)
        for i, length in enumerate(lens if past else ()):
            sign = torch.randint(0, 2, (n - length, 2 * H * 64), generator=gen, device=dev)
            qkv[i, length:, H * 64:] = past * (2.0 * sign - 1)
        qkv = qkv.to(torch.bfloat16)
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        cos, sin = tables(n)
        got = fp.flash_prefix_qkv_attention(qkv, kv, H, cos, sin, pe)
        torch.cuda.synchronize()
        live = [i for i, length in enumerate(lens) if length > 0]
        for i, length in enumerate(lens):
            if length == 0 and got[i].abs().max().item():
                fail(f"kernel 19 {label}: item {i} with no valid key is not zero")
        want = fp.flash_prefix_qkv_reference(qkv[live], kv[live], H, cos, sin, pe)
        compare(f"kernel 19 {label}", got[live], want, 1e-2)
        q, k, v = (t.contiguous() for t in fp.qkv_unpack(qkv, H))
        got18 = fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin, pe)
        torch.cuda.synchronize()
        for i, length in enumerate(lens):
            if length == 0 and got18[i].abs().max().item():
                fail(f"kernel 18 {label}: item {i} with no valid key is not zero")
        compare(f"kernel 18 {label}", merge(got18[live]), want, 1e-2)
        compare(f"kernel 18 vs kernel 19 on the same values, {label}", merge(got18), got, 1e-2,
                exact=True)
        via_a = fp.flash_prefix_attention(fp.rope_reference(q[live], cos, sin, pe),
                                          fp.rope_reference(k[live], cos, sin, pe), v[live],
                                          kv[live])
        compare(f"kernel 19 vs kernel A on torch-roped q, k, {label}", got[live], merge(via_a),
                5e-3)

    print("kernels 18 and 19, prefix attention with rope in the kernel, both on the attention "
          "core's rope form (bf16, rel bound 1e-2 to the plain version as for kernel A; 5e-3 "
          "to kernel A on torch-roped inputs; 18 equal to 19 to the bit on the same values). "
          "Rope in fp32 from bf16 tables, rounded once; the TPU kernel multiplies in bf16")
    (e18, e19), (qkv, q, k, v, kv, cos, sin, got18, got19) = case(
        "main B=2 heads=16 n=1536 kv=1376", 2, 16, 1536, [1376, 1376], None)
    case("n=1000 kv=[10, 1000] all heads", 2, 4, 1000, [10, 1000], None)
    case("n=1000 kv=[0, 700] pe_attn_head=1", 2, 4, 1000, [0, 700], 1)
    case("n=300 kv=[300, 1, 129] pe_attn_head=1", 3, 2, 300, [300, 1, 129], 1)
    case("n=300 kv=[300, 1, 129] pe_attn_head=0 (no head rotates)", 3, 2, 300, [300, 1, 129], 0)
    # kernels 19 and 18 on the attention core at its tiles' edges: n around
    # the 128-key tiles and the 192-row query blocks, kv_len 0, 1, 127-129 and
    # n, K and V rows past kv_len at +-1e4, heads 2 and 16, B 1-3
    for B, H, n, lens, pe, past in QKV_EDGES:
        case19(f"B={B} heads={H} n={n} kv={lens} pe_attn_head={pe}"
               f"{f' past=+-{past:g}' if past else ''}", B, H, n, lens, pe, past)
    flop = 4.0 * 32 * 1536 * 1376 * 64  # every query row against this run's 1376 keys
    out = {}
    t18 = _timed(lambda: fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin),
                 lambda: fp.flash_prefix_rope_reference(q, k, v, kv, cos, sin), flop,
                 (q, k, v, kv, cos, sin, got18), kind="bf16")
    _context("the default path's apply_rope x 2 + kernel A",
             lambda: fp.flash_prefix_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                                               v, kv))
    out["flash_prefix_rope"] = {"max_abs_err": e18, **t18}
    t19 = _timed(lambda: fp.flash_prefix_qkv_attention(qkv, kv, 16, cos, sin),
                 lambda: fp.flash_prefix_qkv_reference(qkv, kv, 16, cos, sin), flop,
                 (qkv, kv, cos, sin, got19), kind="bf16")

    def default_qkv():
        qs, ks, vs = fp.qkv_unpack(qkv, 16)
        return merge(fp.flash_prefix_attention(apply_rope(qs, cos, sin), apply_rope(ks, cos, sin),
                                               vs, kv))

    _context("kernel 19 without its rotation (pe_attn_head 0, the same core and layout)",
             lambda: fp.flash_prefix_qkv_attention(qkv, kv, 16, cos, sin, 0))
    composed = _context("the default path's head split + apply_rope x 2 + kernel A + head "
                        "merge", default_qkv)
    print(f"  kernel 19 takes {t19['ms'] / composed:.3f}x the time of the default path's "
          "composition")
    out["flash_prefix_qkv"] = {"max_abs_err": e19, **t19}
    return out


# ---------------------------------------------------------------------------
# --ab: the product cores' kernels of two checkouts under one timer
# ---------------------------------------------------------------------------

# the kernels a change to the product cores (csrc/hopper.cuh, gemm_bf16.cuh,
# gemm_int8.cuh) or to the attention cores (attn_wgmma.cuh, attn_bwd_wgmma.cuh)
# can move: A, 10, 14, 18, 19 (the attention core), B, 7, 8 (bf16), 4, 5, 6,
# 9 (int8), 11, 12, 13 (training), C, and kernel 14's quantization pass (in
# a tree without the pass's kernel, its torch-ops composition, the wrapper's
# own); beside A, the library yardstick (SDPA on keys sliced to the common
# kv_len) under each backend, timed in the same process as the tree's
# kernels
AB_KERNELS = {"flash_prefix": "A", "ff_block": "B", "grouped_conv": "C",
              "ln_mod_matmul": "7", "proj_gated_residual": "8", "ff_block_int8": "4",
              "ln_mod_matmul_int8": "5", "proj_gated_residual_int8": "6", "qmatmul": "9",
              "flash_prefix_lse": "10", "flash_prefix_dq_lsein": "11", "flash_prefix_dq": "12",
              "flash_prefix_dkv": "13", "flash_prefix_rope": "18", "flash_prefix_qkv": "19",
              "flash_prefix_i8": "14 qkpv + its pass", "flash_prefix_i8_qk": "14 qk + its pass",
              "flash_prefix_f32": "A fp32", "ff_block_f32": "B fp32", "grouped_conv_f32": "C fp32",
              "flash_prefix_lse_f32": "10 fp32", "flash_prefix_dq_lsein_f32": "11 fp32",
              "flash_prefix_dq_f32": "12 fp32", "flash_prefix_dkv_f32": "13 fp32",
              "ln_mod_matmul_f32": "7 fp32", "proj_gated_residual_f32": "8 fp32",
              "flash_prefix_rope_f32": "18 fp32", "flash_prefix_qkv_f32": "19 fp32",
              "flash_prefix_i8_f32": "14 fp32 qkpv + its pass",
              "flash_prefix_i8_qk_f32": "14 fp32 qk + its pass",
              "flash_prefix_i8_d128": "14 d128 qkpv", "flash_prefix_i8_qk_d128": "14 d128 qk",
              "flash_prefix_i8_f32_d128": "14 d128 fp32 qkpv",
              "flash_prefix_i8_qk_f32_d128": "14 d128 fp32 qk",
              "flash_prefix_i8_quant_d128": "14's pass d128",
              "flash_prefix_dq_lsein_d128": "11 d128", "flash_prefix_dq_d128": "12 d128"}
AB_SDPA = {f"sdpa_{name.split('_')[0].lower()}": f"SDPA {name}" for name in SDPA_BACKENDS}
AB_LIBRARY = {**AB_SDPA, "flash_fwd": "library flash forward (10's yardstick)",
              "flash_bwd": "library flash backward (11 + 13's yardstick)",
              "efficient_sliced_f32": "library efficient attention, fp32, sliced keys (A fp32's "
                                      "yardstick)",
              "efficient_fwd_f32": "library efficient forward with lse, fp32 (10 fp32's "
                                   "yardstick)",
              "efficient_bwd_f32": "library efficient backward, fp32 (11 + 13 fp32's yardstick)"}
# no slower than 1.05x the parent or fail: every kernel this change does not
# redesign (12 moves onto the dq core; 14's forms on the attention core take
# their max per 512-key chunk, a second S sweep; 14's four forms at d = 128
# leave mma.sync and FFMA; 11 and 12 in bf16 at d = 128 leave mma.sync for the
# backward core's D = 128 dq form: timed, not held)
AB_UNMOVED = ("flash_prefix", "ff_block", "grouped_conv", "ln_mod_matmul",
              "proj_gated_residual", "ff_block_int8", "ln_mod_matmul_int8",
              "proj_gated_residual_int8", "qmatmul", "flash_prefix_lse", "flash_prefix_dq_lsein",
              "flash_prefix_dkv", "flash_prefix_rope", "flash_prefix_qkv",
              "flash_prefix_f32", "ff_block_f32", "grouped_conv_f32",
              "flash_prefix_lse_f32", "flash_prefix_dq_lsein_f32", "flash_prefix_dq_f32",
              "flash_prefix_dkv_f32", "ln_mod_matmul_f32", "proj_gated_residual_f32",
              "flash_prefix_rope_f32", "flash_prefix_qkv_f32", "flash_prefix_i8_qk_f32",
              "flash_prefix_i8_quant_d128")
AB_BOUND = 1.05
# their times when the bf16 core was built (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6, kernel table)
BF16_CORE_MS = {"ff_block": 0.0824, "ln_mod_matmul": 0.0566, "proj_gated_residual": 0.0198}


def core_timings(dev, absent=()) -> dict[str, float]:
    """ms at the main shape (m = 3072, d = 1024, dff = 2048; attention H 32
    (18, 19: B 2 x 16 heads), n 1536, kv_len 1376; training attention H 128,
    n 1280, every key valid; kernel 14 at d = 128 alone on its pass's
    operands, and the pass, at the d = 128 serving shape: H 16 (B 2 x 8
    heads), n 1536, kv_len 1376; 11 and 12 in bf16 at the d = 128 training
    shape, H 64, n 1280, every key valid)
    of the AB_KERNELS but those named in `absent` (forms the tree lacks),
    through the public wrappers of whichever korean_f5_tts_tpu_torch is
    first on sys.path, each held against its plain version before it is
    timed; and the AB_LIBRARY calls."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import rope_cos_sin
    from korean_f5_tts_tpu_torch.ops import ff_block as fb
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl
    from korean_f5_tts_tpu_torch.ops import grouped_conv as gc
    from korean_f5_tts_tpu_torch.ops import qmatmul as qm

    gen = torch.Generator(device=dev).manual_seed(0)
    h, a = (torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    sc, sh, gate = (_uni(gen, dev, (1024,), bound) for bound in (0.3, 0.3, 1.0))
    w1, w2 = _linear(gen, dev, 2048, 1024), _linear(gen, dev, 1024, 2048)
    ff = (h, sc, sh, gate, w1["w"], w1["b"], w2["w"], w2["b"])
    ps = [_linear(gen, dev, 1024, 1024) for _ in range(3)]
    qp_in, qp_out = _int8_linear(gen, dev, 2048, 1024), _int8_linear(gen, dev, 1024, 2048)
    qps = [_int8_linear(gen, dev, 1024, 1024) for _ in range(3)]
    x = a.reshape(3072, 1024)
    aq, ak, av = (torch.randn((32, 1536, 64), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    kv = torch.full((32,), 1376, dtype=torch.int32, device=dev)
    tq, tk, tv, tdo = (torch.randn((128, 1280, 64), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
    tkv = torch.full((128,), 1280, dtype=torch.int32, device=dev)
    to, tlse = fp.prefix_attention_lse_reference(tq, tk, tv, tkv)
    tdvec = (tdo.float() * to.float()).sum(-1)
    train = (tq, tk, tv, tdo, tdvec, tlse, tkv)
    qkv = torch.randn((2, 1536, 3 * 1024), generator=gen, device=dev).to(torch.bfloat16)
    rq, rk, rv = (t.contiguous() for t in fp.qkv_unpack(qkv, 16))
    rkv = torch.full((2,), 1376, dtype=torch.int32, device=dev)
    cos, sin = (torch.from_numpy(t).to(dev).to(torch.bfloat16) for t in rope_cos_sin(1536, 64))
    cw = _uni(gen, dev, (31, 64, 1024), (64 * 31) ** -0.5)
    cb = _uni(gen, dev, (1024,), (64 * 31) ** -0.5)
    # kernel 14 with its quantization pass, as the attention calls them (the
    # pass alone is timed in phase 2)
    q4, k4, v4 = (t.reshape(2, 16, 1536, 64) for t in (aq, ak, av))

    def i8(pv_i8):
        return fp.flash_prefix_attention_i8(q4, k4, v4, rkv, pv_i8=pv_i8).reshape(32, 1536, 64)

    calls = {
        "flash_prefix": (lambda: fp.flash_prefix_folded(aq, ak, av, kv),
                         lambda: fp.prefix_attention_reference(aq, ak, av, kv), 1e-2),
        "ff_block": (lambda: fb.ff_block_fused(*ff), lambda: fb.ff_block_reference(*ff), 5e-3),
        "ln_mod_matmul": (lambda: fl.ln_mod_matmul(h, sc, sh, ps),
                          lambda: fl.ln_mod_matmul_reference(h, sc, sh, ps), 5e-3),
        "proj_gated_residual": (lambda: fl.proj_gated_residual(a, h, gate, ps[0]),
                                lambda: fl.proj_gated_residual_reference(a, h, gate, ps[0]),
                                5e-3),
        "ff_block_int8": (lambda: fb.ff_block_fused_int8(h, sc, sh, gate, qp_in, qp_out),
                          lambda: fb.ff_block_int8_reference(h, sc, sh, gate, qp_in, qp_out),
                          INT8_REL),
        "ln_mod_matmul_int8": (lambda: fl.ln_mod_matmul_int8(h, sc, sh, qps),
                               lambda: fl.ln_mod_matmul_int8_reference(h, sc, sh, qps),
                               INT8_REL),
        "proj_gated_residual_int8": (
            lambda: fl.proj_gated_residual_int8(a, h, gate, qps[0]),
            lambda: fl.proj_gated_residual_int8_reference(a, h, gate, qps[0]), INT8_REL),
        "qmatmul": (lambda: qm.qmatmul(x, qps[1]["w_int8"], qps[1]["w_scale"], qps[1]["b"]),
                    lambda: qm.qmatmul_reference(x, qps[1]["w_int8"], qps[1]["w_scale"],
                                                 qps[1]["b"]), INT8_REL),
        "flash_prefix_lse": (lambda: fp.flash_prefix_folded_lse(tq, tk, tv, tkv)[0],
                             lambda: to, 1e-2),
        "flash_prefix_dq_lsein": (lambda: fp.flash_prefix_dq_lsein(*train),
                                  lambda: fp.flash_prefix_dq_lsein_reference(*train), 1e-2),
        "flash_prefix_dq": (lambda: fp.flash_prefix_dq(tq, tk, tv, tdo, tdvec, tkv)[0],
                            lambda: fp.flash_prefix_dq_reference(tq, tk, tv, tdo, tdvec,
                                                                 tkv)[0], 1e-2),
        "flash_prefix_dkv": (lambda: fp.flash_prefix_dkv(*train)[0],
                             lambda: fp.flash_prefix_dkv_reference(*train)[0], 1e-2),
        "flash_prefix_rope": (
            lambda: fp.flash_prefix_rope_attention(rq, rk, rv, rkv, cos, sin),
            lambda: fp.flash_prefix_rope_reference(rq, rk, rv, rkv, cos, sin), 1e-2),
        "flash_prefix_qkv": (lambda: fp.flash_prefix_qkv_attention(qkv, rkv, 16, cos, sin),
                             lambda: fp.flash_prefix_qkv_reference(qkv, rkv, 16, cos, sin), 1e-2),
        "grouped_conv": (lambda: gc.grouped_conv1d_mish(h, cw, cb, 16),
                         lambda: gc.grouped_conv1d_mish_reference(h, cw, cb, 16), 5e-3),
        "flash_prefix_i8": (lambda: i8(True),
                            lambda: fp.flash_prefix_i8_reference(aq, ak, av, kv), 2e-3),
        "flash_prefix_i8_qk": (lambda: i8(False),
                               lambda: fp.flash_prefix_i8_reference(aq, ak, av, kv, pv_i8=False),
                               5e-3),
    }
    # the fp32 forms on fp32 operands of the same shapes
    f = {name: t.float() for name, t in (("h", h), ("a", a), ("sc", sc), ("sh", sh),
                                        ("gate", gate), ("aq", aq), ("ak", ak), ("av", av),
                                        ("qkv", qkv), ("cos", cos), ("sin", sin))}
    f_ff = tuple(t.float() for t in ff)
    f_cw, f_cb = cw.float(), cb.float()
    f_ps = [{k: t.float() for k, t in p.items()} for p in ps]
    fq, fk, fv = (t.contiguous() for t in fp.qkv_unpack(f["qkv"], 16))
    f4 = [t.reshape(2, 16, 1536, 64) for t in (f["aq"], f["ak"], f["av"])]
    ftrain = tuple(t.float() for t in (tq, tk, tv, tdo))
    fto, ftlse = fp.prefix_attention_lse_reference(*ftrain[:3], tkv)
    fdvec = (ftrain[3] * fto).sum(-1)
    ft = (*ftrain, fdvec, ftlse, tkv)

    def i8_f32(pv_i8):
        return fp.flash_prefix_attention_i8(*f4, rkv, pv_i8=pv_i8).reshape(32, 1536, 64)

    calls.update({
        "flash_prefix_f32": (lambda: fp.flash_prefix_folded(f["aq"], f["ak"], f["av"], kv),
                             lambda: fp.prefix_attention_reference(f["aq"], f["ak"], f["av"], kv),
                             F32_REL),
        "ff_block_f32": (lambda: fb.ff_block_fused(*f_ff), lambda: fb.ff_block_reference(*f_ff),
                         F32_REL),
        "grouped_conv_f32": (lambda: gc.grouped_conv1d_mish(f["h"], f_cw, f_cb, 16),
                             lambda: gc.grouped_conv1d_mish_reference(f["h"], f_cw, f_cb, 16),
                             F32_REL),
        "flash_prefix_lse_f32": (lambda: fp.flash_prefix_folded_lse(*ft[:3], tkv)[0],
                                 lambda: fto, F32_ATTN_REL),
        "flash_prefix_dq_lsein_f32": (lambda: fp.flash_prefix_dq_lsein(*ft),
                                      lambda: fp.flash_prefix_dq_lsein_reference(*ft),
                                      F32_GRAD_REL),
        "flash_prefix_dq_f32": (lambda: fp.flash_prefix_dq(*ft[:5], tkv)[0],
                                lambda: fp.flash_prefix_dq_reference(*ft[:5], tkv)[0],
                                F32_GRAD_REL),
        "flash_prefix_dkv_f32": (lambda: fp.flash_prefix_dkv(*ft)[0],
                                 lambda: fp.flash_prefix_dkv_reference(*ft)[0], F32_GRAD_REL),
        "ln_mod_matmul_f32": (lambda: fl.ln_mod_matmul(f["h"], f["sc"], f["sh"], f_ps),
                              lambda: fl.ln_mod_matmul_reference(f["h"], f["sc"], f["sh"], f_ps),
                              F32_REL),
        "proj_gated_residual_f32": (
            lambda: fl.proj_gated_residual(f["a"], f["h"], f["gate"], f_ps[0]),
            lambda: fl.proj_gated_residual_reference(f["a"], f["h"], f["gate"], f_ps[0]),
            F32_REL),
        "flash_prefix_rope_f32": (
            lambda: fp.flash_prefix_rope_attention(fq, fk, fv, rkv, f["cos"], f["sin"]),
            lambda: fp.flash_prefix_rope_reference(fq, fk, fv, rkv, f["cos"], f["sin"]), F32_REL),
        "flash_prefix_qkv_f32": (
            lambda: fp.flash_prefix_qkv_attention(f["qkv"], rkv, 16, f["cos"], f["sin"]),
            lambda: fp.flash_prefix_qkv_reference(f["qkv"], rkv, 16, f["cos"], f["sin"]),
            F32_REL),
        "flash_prefix_i8_f32": (lambda: i8_f32(True),
                                lambda: fp.flash_prefix_i8_reference(f["aq"], f["ak"], f["av"],
                                                                     kv), INT8_F32_REL),
        "flash_prefix_i8_qk_f32": (lambda: i8_f32(False),
                                   lambda: fp.flash_prefix_i8_reference(
                                       f["aq"], f["ak"], f["av"], kv, pv_i8=False), F32_REL),
    })
    # kernel 14 at d = 128 in its four forms, each alone on the operands of
    # its pass (bf16 or fp32 inputs), and the pass (bf16, "qkpv")
    d8 = [torch.randn((2, 8, 1536, 128), generator=gen, device=dev) for _ in range(3)]
    kv16 = torch.full((16,), 1376, dtype=torch.int32, device=dev)

    def i8_d128(dtype, pv_i8, rel):
        q8, k8, vk, c, sv = fp.quantize_heads(*(t.to(dtype) for t in d8), pv_i8)
        vn = fp._v8_natural_layout(vk, 1536) if pv_i8 else vk
        return (lambda: fp.flash_prefix_folded_i8(q8, k8, vk, c, sv, kv16, pv_i8=pv_i8,
                                                  out_dtype=dtype),
                lambda: fp._i8_attention_plain(q8, k8, vn, c, sv, kv16, pv_i8,
                                               fp.I8_KEY_CHUNK), rel)

    b8 = [t.to(torch.bfloat16) for t in d8]
    calls.update({
        "flash_prefix_i8_d128": i8_d128(torch.bfloat16, True, 2e-3),
        "flash_prefix_i8_qk_d128": i8_d128(torch.bfloat16, False, 5e-3),
        "flash_prefix_i8_f32_d128": i8_d128(torch.float32, True, INT8_F32_REL),
        "flash_prefix_i8_qk_f32_d128": i8_d128(torch.float32, False, F32_ATTN_REL),
        "flash_prefix_i8_quant_d128": (
            lambda: fp.quantize_heads(*b8, True)[2],
            lambda: fp._v8_kernel_layout(fp._quantize_qkv(*b8, True)[2]), 0.0),
    })
    # 11 and 12 in bf16 at the d = 128 training shape
    hq, hk, hv, hdo = (torch.randn((64, 1280, 128), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
    hkv = torch.full((64,), 1280, dtype=torch.int32, device=dev)
    ho, hlse = fp.prefix_attention_lse_reference(hq, hk, hv, hkv)
    htrain = (hq, hk, hv, hdo, (hdo.float() * ho.float()).sum(-1), hlse, hkv)
    calls.update({
        "flash_prefix_dq_lsein_d128": (lambda: fp.flash_prefix_dq_lsein(*htrain),
                                       lambda: fp.flash_prefix_dq_lsein_reference(*htrain), 1e-2),
        "flash_prefix_dq_d128": (lambda: fp.flash_prefix_dq(*htrain[:5], hkv)[0],
                                 lambda: fp.flash_prefix_dq_reference(*htrain[:5], hkv)[0], 1e-2),
    })
    out = {}
    for name, (fn, plain, rel) in calls.items():
        if name in absent:
            continue
        compare(f"kernel {AB_KERNELS[name]} ({name}) main shape", fn(), plain(), rel)
        out[name] = cuda_time_ms(fn)
    # the fp32 library yardsticks: A fp32's (keys sliced to the common kv_len,
    # as check_fp32_forms), 10 fp32's forward with its logsumexp and 11 + 13
    # fp32's backward (as check_train_attention_f32 times them)
    out["efficient_sliced_f32"] = cuda_time_ms(efficient_f32_sliced(f["aq"], f["ak"], f["av"], kv))
    fq4, fk4, fv4 = (t[None] for t in ftrain[:3])
    out["efficient_fwd_f32"] = cuda_time_ms(
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            fq4, fk4, fv4, None, True, 0.0, False, scale=0.125))
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t[None].clone().requires_grad_(True) for t in ftrain[:3]]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=0.125)
    out["efficient_bwd_f32"] = cuda_time_ms(
        lambda: torch.autograd.grad(lib_out, leaves, ftrain[3][None], retain_graph=True))
    del leaves, lib_out
    want = fp.prefix_attention_reference(aq, ak, av, kv)
    for backend, (ms, _) in sdpa_times(aq, ak, av, kv, want).items():
        out[f"sdpa_{backend.split('_')[0].lower()}"] = ms
    out["flash_fwd"], out["flash_bwd"] = flash_library_times(tq, tk, tv, tdo, tkv, tlse, tdvec)
    return out


def ab_timings(parent: Path, card: str, absent: tuple[str, ...] = ()) -> None:
    """core_timings of the checkout at `parent` and of this one, each in a
    process of its own (both packages have one name), in turns parent,
    change, change, parent; prints the table and fails if a kernel of
    AB_UNMOVED of the change is more than 5% slower than of the parent (mean
    against mean). `absent`: kernels the parent lacks, not run in its turns."""
    unknown = [name for name in absent if name not in AB_KERNELS or name in AB_UNMOVED]
    if unknown:
        fail(f"--ab-absent: {unknown} are not kernels of AB_KERNELS outside AB_UNMOVED")
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        skip = ["--ab-absent", ",".join(absent)] if tree is parent and absent else []
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--timings-of",
                               str(tree.resolve()), *skip], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n")
            fail(f"--timings-of {tree} exited {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"ms at the main shape, one timer (cuda_time_ms), {card}; parent {parent}")
    print("| kernel | parent | change | change | parent | change / parent |")
    print("|---|---|---|---|---|---|")
    ratio = {}
    for name, label in {**AB_KERNELS, **AB_LIBRARY}.items():
        t = [r.get(name) for r in runs]
        if None in t:  # a backend that refused the call, or a form the parent lacks
            print(f"| {label} | " + " | ".join(
                ("absent" if name in absent else "refused") if v is None else f"{v:.4f}"
                for v in t) + " | - |")
            continue
        ratio[name] = (t[1] + t[2]) / (t[0] + t[3])
        print(f"| {label if name in AB_LIBRARY else f'{label} ({name})'} | "
              + " | ".join(f"{v:.4f}" for v in t) + f" | {ratio[name]:.3f} |")
    for turn, r in zip(("parent", "change", "change", "parent"), runs):
        lib = {AB_SDPA[n]: r[n] for n in AB_SDPA if n in r}
        best = min(lib, key=lib.get)
        bwd = r["flash_prefix_dq_lsein"] + r["flash_prefix_dkv"]
        whole = r["flash_prefix_i8"]
        print(f"14 qkpv + its pass ({turn}) {whole:.4f} ms against A {r['flash_prefix']:.4f}: "
              f"{whole / r['flash_prefix']:.2f}x")
        print(f"A ({turn}) {r['flash_prefix']:.4f} ms against the fastest library call, {best} "
              f"{lib[best]:.4f} ms: {r['flash_prefix'] / lib[best]:.2f}x; 10 "
              f"{r['flash_prefix_lse']:.4f} against the flash forward {r['flash_fwd']:.4f}: "
              f"{r['flash_prefix_lse'] / r['flash_fwd']:.2f}x; 11 + 13 {bwd:.4f} against the "
              f"flash backward {r['flash_bwd']:.4f}: {bwd / r['flash_bwd']:.2f}x")
        bwd32 = r["flash_prefix_dq_lsein_f32"] + r["flash_prefix_dkv_f32"]
        print(f"11 + 13 fp32 ({turn}) {bwd32:.4f} ms against the library efficient backward "
              f"on fp32 {r['efficient_bwd_f32']:.4f}: {bwd32 / r['efficient_bwd_f32']:.2f}x; 10 "
              f"fp32 {r['flash_prefix_lse_f32']:.4f} against its forward "
              f"{r['efficient_fwd_f32']:.4f}: "
              f"{r['flash_prefix_lse_f32'] / r['efficient_fwd_f32']:.2f}x; A fp32 "
              f"{r['flash_prefix_f32']:.4f} against it on sliced keys "
              f"{r['efficient_sliced_f32']:.4f}: "
              f"{r['flash_prefix_f32'] / r['efficient_sliced_f32']:.2f}x")
    moved = [AB_KERNELS[n] for n in AB_UNMOVED if ratio[n] > AB_BOUND]
    print(", ".join(AB_KERNELS[n] for n in AB_UNMOVED) + " change / parent: "
          + ", ".join(f"{ratio[n]:.3f}" for n in AB_UNMOVED)
          + f" (bound {AB_BOUND}): {'ok' if not moved else 'FAIL'}")
    if moved:
        fail(f"kernels {', '.join(moved)} are slower than in the parent")


# ---------------------------------------------------------------------------
# phase 3: full-width model behind the HTTP server
# ---------------------------------------------------------------------------

HOP, SR = 256, 24_000
DEPTH, STEPS = 22, 16
REF_TEXT = "This is the reference speech."


def build_model(dev, quantize: bool = False):
    """F5TTS_v1_Base + Vocos in bf16, seeded random weights, AdaLN re-drawn;
    quantize=True gives the same weights with int8 block linears."""
    import torch

    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import count_params, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos

    model = load_model(preset_model_config("F5TTS_v1_Base"),
                       vocab_file=str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"),
                       dtype=torch.bfloat16, seed=0, device=dev, quantize=quantize)
    redraw_zero_init(model.params, seed=1)  # the AdaLN layers are never quantized
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    arch = model.arch
    print(f"  DiT dim {arch.dim} depth {arch.depth} heads {arch.heads}x{arch.dim_head} "
          f"ff_mult {arch.ff_mult} text_dim {arch.text_dim} text embeds {arch.text_num_embeds}: "
          f"{count_params(model.params) / 1e6:.1f} M params; Vocos "
          f"{count_params(vocoder.params) / 1e6:.1f} M params; "
          f"{'int8 block linears, bf16 compute' if quantize else 'bf16'}")
    if arch.depth != DEPTH:
        fail(f"expected depth {DEPTH}, got {arch.depth}")
    return model, vocoder


def chirp_wav_b64(seconds: float) -> tuple[str, int]:
    """A 0.3-amplitude chirp as a base64 16-bit wav; returns (b64, samples)."""
    import base64
    import io

    import numpy as np
    from scipy.io import wavfile

    t = np.arange(int(seconds * SR)) / SR
    wav = 0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * t) * t)
    buf = io.BytesIO()
    wavfile.write(buf, SR, (wav * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode(), wav.size


def expected_samples(ref_samples: int, target: str) -> int:
    """(duration - ref_frames) * hop for the server's byte-ratio duration rule."""
    ref_frames = ref_samples // HOP + 1          # center-padded mel frames
    ref_bytes = len(REF_TEXT.encode()) + 1       # the server appends a space
    dur = ref_frames + int(ref_frames * len(target.encode()) / ref_bytes)
    return (dur - ref_frames) * HOP


def expected_launches(mode: str, batches: int, attn_path: str = "default",
                      attn_int8: str | None = None) -> dict[str, int]:
    """Launches of each kernel while serving one batch of 1 and one of 2 (22
    blocks x 16 steps each). bf16: the attention kernel and B per block, C
    twice per step; the attention kernel is A, or 18 under "rope_in_kernel",
    or 19 under "qkv_kernel"; "linear_fused" adds 7 and 8 per block at batch
    1 only (a batch of 2 carries a duration mask and takes attention()).
    int8: A and 4 per block; 5 and 6 per block at batch 1 (no duration
    mask); kernel 9 for each of q, k, v and out per block at batch 2.
    attn_int8 puts kernel 14 in kernel A's place, every launch of it, each
    after one launch of its quantization pass."""
    from korean_f5_tts_tpu_torch.ops import KERNELS

    per = DEPTH * STEPS
    want = dict.fromkeys(KERNELS, 0)
    attn = {"rope_in_kernel": "flash_prefix_rope", "qkv_kernel": "flash_prefix_qkv"}
    want[attn.get(attn_path, "flash_prefix_i8" if attn_int8 else "flash_prefix")] = per * batches
    if attn_int8:  # kernel 14's quantization pass, one launch before each
        want["flash_prefix_i8_quant"] = per * batches
    want["grouped_conv"] = 2 * STEPS * batches
    if mode == "bf16":
        want["ff_block"] = per * batches
        if attn_path == "linear_fused":
            want.update(ln_mod_matmul=per, proj_gated_residual=per)
    else:
        want.update(ff_block_int8=per * batches, ln_mod_matmul_int8=per,
                    proj_gated_residual_int8=per, qmatmul=4 * per)
    return want


# each bf16 counter's fp32 form: cfm_sample keeps cond's fp32 beside bf16 or
# int8 weights (models/cfm.py:weights_at), so every kernel takes its fp32
# form there; kernels 4, 5, 6 and 9 take fp32 rows under their own counters
F32_FORMS = {"flash_prefix": "flash_prefix_f32", "ff_block": "ff_block_f32",
             "grouped_conv": "grouped_conv_f32", "ln_mod_matmul": "ln_mod_matmul_f32",
             "proj_gated_residual": "proj_gated_residual_f32",
             "flash_prefix_rope": "flash_prefix_rope_f32",
             "flash_prefix_qkv": "flash_prefix_qkv_f32",
             "flash_prefix_i8_quant": "flash_prefix_i8_quant_f32",
             "grouped_conv_g8": "grouped_conv_f32_g8"}


def on_fp32_rows(want: dict[str, int], attn_int8: str | None = None) -> dict[str, int]:
    """The launches `want` of a path at bf16 activations, run at fp32 ones:
    each kernel's fp32 form (kernel 14 by attn_int8: "qkpv" on the int8
    core with an fp32 epilogue, "qk" split 3xTF32)."""
    forms = dict(F32_FORMS, flash_prefix_i8={"qkpv": "flash_prefix_i8_f32",
                                             "qk": "flash_prefix_i8_qk_f32"}.get(attn_int8, ""))
    out = dict.fromkeys(want, 0)
    for name, n in want.items():
        if n:
            out[forms.get(name, name)] += n
    return out


def phase3_serve(model, vocoder, mode: str, attn_path: str = "default",
                 attn_int8: str | None = None, warm: bool = False,
                 want_per_batch: dict[str, int] | None = None,
                 phase: int | None = None) -> dict[str, int]:
    """Three HTTP requests (one alone, then two as one batch) through the
    port's serve(), with exact launch counts: expected_launches' for the DiT,
    or want_per_batch (the launches of one batch of any size) times the
    batches for another backbone."""
    import io
    import threading
    import urllib.request

    import numpy as np
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.serving.server import serve, warm_start

    phase = phase or (9 if attn_int8 else 3 if attn_path == "default" else 7)
    print(f"phase {phase} ({mode}, attn_path {attn_path}, attn_int8 {attn_int8}): "
          f"{'warm_start(), then ' if warm else ''}serve() on localhost, 3 POST /tts requests "
          "(1 alone, then 2 at once)")
    if warm:  # the buckets and batch sizes the three requests will hit
        t0 = time.perf_counter()
        warm_start(model, vocoder, [640, 768], STEPS, batch_sizes=(1, 2), text_tokens=64,
                   attn_path=attn_path, attn_int8=attn_int8)
        print(f"  warm_start: {time.perf_counter() - t0:.2f} s")
    httpd, service = serve(model, vocoder, host="127.0.0.1", port=0, max_batch=8,
                           max_wait_us=300_000, attn_path=attn_path, attn_int8=attn_int8)
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    ref_b64, ref_samples = chirp_wav_b64(3.0)
    targets = ["Hello from the first request of the port.",
               "A second request in a batch.", "A third one, batched as well!"]
    results: dict[int, tuple] = {}

    def post(i: int, seed: int) -> None:
        body = json.dumps({"reference_audio": ref_b64, "reference_text": REF_TEXT,
                           "target_text": targets[i], "seed": seed}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            results[i] = (resp.status, resp.read(), time.perf_counter() - t0)

    try:
        reset_launch_counts()
        post(0, 11)
        pair = [threading.Thread(target=post, args=(i, 7)) for i in (1, 2)]
        for t in pair:
            t.start()
        for t in pair:
            t.join(timeout=600)
        counts = launch_counts()
        for i, target in enumerate(targets):
            if i not in results:
                fail(f"request {i} got no response")
            status, body, secs = results[i]
            sr, wav = wavfile.read(io.BytesIO(body))
            want = expected_samples(ref_samples, target)
            w = wav.astype(np.float64) / 32768.0
            rms = float(np.sqrt(np.mean(w * w))) if w.size else 0.0
            print(f"  request {i}: HTTP {status}, {secs:.2f} s, {wav.dtype} {sr} Hz, "
                  f"{wav.size} samples (expected {want}), rms {rms:.4f}")
            if status != 200 or sr != SR or wav.dtype != np.int16 or wav.ndim != 1:
                fail(f"request {i}: not a 24 kHz mono int16 wav")
            if wav.size != want or not np.isfinite(w).all() or rms <= 0:
                fail(f"request {i}: wrong length or silent audio")
        sizes = service.stats["batch_sizes"]
        print(f"  batches {service.stats['batches']} with sizes {sizes}")
        if sorted(sizes) != [1, 2]:
            fail(f"expected one batch of 1 and one of 2, got {sizes}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()
        server_thread.join(timeout=10)
    if want_per_batch is None:
        want = expected_launches(mode, len(sizes), attn_path, attn_int8)
    else:
        want = {k: v * len(sizes) for k, v in want_per_batch.items()}
    print(f"  kernel launches during serving: {counts} (expected {want})")
    if counts != want:
        fail("a kernel of the main path did not run as often as the path requires")
    return counts


# ---------------------------------------------------------------------------
# phases 4 and 5: bench protocol, kernels vs plain, and RTF
# ---------------------------------------------------------------------------


def bench_inputs(dev, cond_len=432, total_len=1376, n_bucket=1536):
    """bench.py's single-utterance protocol with seeded inputs."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    cond = torch.randn((1, n_bucket, 100), generator=gen, device=dev).to(torch.bfloat16)
    cond_mask = torch.zeros((1, n_bucket, 1), dtype=torch.bool, device=dev)
    cond_mask[:, :cond_len] = True
    step_cond = cond.masked_fill(~cond_mask, 0.0)
    text = torch.randint(1, 2545, (1, 160), generator=gen, device=dev, dtype=torch.int32)
    y0 = torch.randn((1, n_bucket, 100), generator=gen, device=dev).to(torch.bfloat16)
    pad_mask = (torch.arange(n_bucket, device=dev) < total_len)[None]
    return step_cond, cond_mask, text, y0, pad_mask, total_len - cond_len


def batch2_inputs(dev, cond_len=432, totals=(1376, 1200), n_bucket=1536):
    """Two utterances of the bench protocol's bucket as one batch under a
    duration mask (the path on which int8 weights run kernel 9): seeded
    inputs, noise zero past each duration; returns bench_inputs' tuple and
    the mask."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.arange(n_bucket, device=dev)[None]
    mask = frames < torch.as_tensor(totals, device=dev)[:, None]
    cond = torch.randn((2, n_bucket, 100), generator=gen, device=dev).to(torch.bfloat16)
    cond_mask = (frames < cond_len)[..., None].expand(2, n_bucket, 1)
    step_cond = cond.masked_fill(~cond_mask, 0.0)
    text = torch.randint(1, 2545, (2, 160), generator=gen, device=dev, dtype=torch.int32)
    y0 = torch.randn((2, n_bucket, 100), generator=gen, device=dev).to(torch.bfloat16)
    y0 = y0.masked_fill(~mask[..., None], 0.0)
    pad_mask = frames < max(totals)
    return (step_cond, cond_mask, text, y0, pad_mask, max(totals) - cond_len), mask


def synthesize(model, vocoder, inputs, kernels: bool = True, params=None,
               attn_path: str = "default", attn_int8: str | None = None, mask=None,
               mesh=None):
    """One bench-protocol utterance (or a batch under the duration mask
    `mask`): sampler, cond splice, Vocos -> (mel, wav). With a mesh, params
    is this process's share of a tensor-parallel model (phase 12)."""
    from korean_f5_tts_tpu_torch.models.cfm import _sample_core
    from korean_f5_tts_tpu_torch.models.vocos import vocos_decode

    step_cond, cond_mask, text, y0, pad_mask, _ = inputs
    mel = _sample_core(params or model.params, model.arch, step_cond, text, mask, pad_mask,
                       y0, 2.0, -1.0, steps=STEPS, use_cfg=True, use_sway=True,
                       use_epss=True, kernels=kernels, attn_path=attn_path, attn_int8=attn_int8,
                       mesh=mesh)
    out = mel.where(~cond_mask, step_cond)
    wav = vocos_decode(vocoder.params, out.transpose(1, 2).to(step_cond.dtype), vocoder.vcfg)
    return mel, wav


def phase4_parity(model, vocoder, dev, mode: str, bf16_plain=None):
    """Kernels vs plain versions through the sampler; returns the plain mel.
    bf16 prints the plain bf16-vs-fp32 gap for scale, int8 the plain
    int8-vs-bf16 gap (bf16_plain: the bf16 model's plain mel)."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import cast_params

    print(f"phase 4 ({mode}): bench protocol (cond 432, total 1376, bucket 1536, 16 NFE, "
          "CFG 2, sway -1, batch 1), kernels vs plain on the card")
    inputs = bench_inputs(dev)
    total = 1376
    mel_k, wav_k = synthesize(model, vocoder, inputs, kernels=True)
    mel_p, _ = synthesize(model, vocoder, inputs, kernels=False)
    torch.cuda.synchronize()

    def rel(a, b):
        a, b = a[:, :total].float(), b[:, :total].float()
        return ((a - b).norm() / b.norm()).item()

    if not (torch.isfinite(mel_k).all() and torch.isfinite(wav_k).all()):
        fail("non-finite mel or waveform")
    if mel_k[:, :total].abs().max().item() == 0:
        fail("the mel is exactly zero: the model is gated off")
    err = rel(mel_k, mel_p)
    bound = 5e-2
    print(f"  mel rel err, kernels vs plain ({mode}): {err:.3e} (bound {bound:.0e})")
    if mode == "bf16":
        f32 = [t.float() if t.is_floating_point() else t for t in inputs[:5]] + [inputs[5]]
        mel_32, _ = synthesize(model, vocoder, f32, kernels=False,
                               params=cast_params(model.params, torch.float32))
        print(f"  for scale: plain bf16 vs plain fp32 {rel(mel_p, mel_32):.3e}, kernels bf16 "
              f"vs plain fp32 {rel(mel_k, mel_32):.3e}; mel shape {tuple(mel_k.shape)}, "
              f"mean |mel| {mel_k[:, :total].float().abs().mean().item():.3f}")
    else:
        print(f"  for scale (not gated): plain int8 vs plain bf16 {rel(mel_p, bf16_plain):.3e}, "
              f"kernels int8 vs plain bf16 {rel(mel_k, bf16_plain):.3e}; mean |mel| "
              f"{mel_k[:, :total].float().abs().mean().item():.3f}")
    if err > bound:
        fail("the sampler with kernels disagrees with the plain versions")
    return mel_p


def phase5_rtf(model, vocoder, dev, card: str, mode: str, attn_path: str = "default",
               plain: bool = True, attn_int8: str | None = None) -> float:
    import torch

    inputs = bench_inputs(dev)
    gen_seconds = inputs[5] * HOP / SR
    phase = 9 if attn_int8 else 5 if attn_path == "default" else 7
    print(f"phase {phase} ({mode}, attn_path {attn_path}, attn_int8 {attn_int8}): RTF at "
          f"the bench protocol ({gen_seconds:.4f} s generated), 1 warm-up + 10 timed runs each")
    out = {}
    for kernels in (True, False) if plain else (True,):
        synthesize(model, vocoder, inputs, kernels=kernels, attn_path=attn_path,
                   attn_int8=attn_int8)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            synthesize(model, vocoder, inputs, kernels=kernels, attn_path=attn_path,
                       attn_int8=attn_int8)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        mean = sum(times) / len(times)
        out[kernels] = mean / gen_seconds
        label = "kernels" if kernels else "plain  "
        print(f"  {mode} {attn_path} attn_int8={attn_int8} {label}: {mean * 1e3:.2f} ms per "
              f"utterance (min "
              f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), RTF {out[kernels]:.5f} "
              f"[{card}]")
    return out[True]


# ---------------------------------------------------------------------------
# phase 7: the opt-in attention paths; phase 8: the offline entry point
# ---------------------------------------------------------------------------

OPT_IN_PATHS = ("linear_fused", "rope_in_kernel", "qkv_kernel")


def phase7_attn_paths(model, vocoder, dev, card: str, default_rtf: float | None,
                      profile: Path | None = None) -> dict[str, int]:
    """Each opt-in attention path through serve() with exact launch counts,
    its bench-protocol mel against its own plain versions and the default
    path's mel, and its RTF beside the default path's."""
    import torch

    from korean_f5_tts_tpu_torch.ops import KERNELS

    inputs = bench_inputs(dev)
    total = 1376

    def rel(a, b):
        a, b = a[:, :total].float(), b[:, :total].float()
        return ((a - b).norm() / b.norm()).item()

    mel_default, _ = synthesize(model, vocoder, inputs)
    if default_rtf is None:
        default_rtf = phase5_rtf(model, vocoder, dev, card, "bf16", plain=False)
    counts = dict.fromkeys(KERNELS, 0)
    rtfs = {"default": default_rtf}
    for path in OPT_IN_PATHS:
        for name, n in phase3_serve(model, vocoder, "bf16", path).items():
            counts[name] += n
        mel_k, wav_k = synthesize(model, vocoder, inputs, attn_path=path)
        mel_p, _ = synthesize(model, vocoder, inputs, kernels=False, attn_path=path)
        torch.cuda.synchronize()
        if not (torch.isfinite(mel_k).all() and torch.isfinite(wav_k).all()):
            fail(f"{path}: non-finite mel or waveform")
        err = rel(mel_k, mel_p)
        print(f"phase 7 ({path}): bench-protocol mel rel err, kernels vs plain {err:.3e} (bound "
              f"5e-2); vs the default path's kernels {rel(mel_k, mel_default):.3e} (printed, "
              "not gated: other rounding points)")
        if err > 5e-2:
            fail(f"{path}: the sampler with kernels disagrees with the plain versions")
        rtfs[path] = phase5_rtf(model, vocoder, dev, card, "bf16", path, plain=False)
        if profile is not None:
            profile_once(lambda: synthesize(model, vocoder, inputs, attn_path=path),
                         profile.with_suffix(f".{path}.txt"), f"bf16 {path}")
    print("phase 7: RTF by attn_path (bf16, bench protocol, kernels): "
          + ", ".join(f"{k} {v:.5f}" for k, v in rtfs.items()) + f" [{card}]")
    return counts


GEN_TEXT = ("The quick brown fox jumps over the lazy dog near the quiet river bank, and then it "
            "rests for a while under the old oak tree. A short one follows. Every morning the "
            "baker opens the small shop on the corner, lights the oven, kneads the dough, and "
            "greets the first customers of the day with a smile! Does the evening train still "
            "stop at the little station by the lake, or has the timetable changed again this "
            "year? Nobody in the village seems to know for sure.")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def offline_fp32(dev, card: str, ref_path: str, chunks, want_samples: int, frames: int,
                 spec_bf16) -> dict[str, int]:
    """The offline entry point with its own defaults: F5TTS(device="cuda") keeps
    fp32 weights, so the default path runs the fp32 forms of kernels A, B and
    C. Run once as a user gets it (cuDNN convolutions in TF32, PyTorch's
    default) and once with them in fp32; the mel of the second against the
    same path's plain versions and the bf16 path, mel and waveform of the two
    against each other; then the same sampler on the card against the CPU,
    fp32, depth 2."""
    import dataclasses

    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.api import F5TTS
    from korean_f5_tts_tpu_torch.infer import utils_infer
    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts

    def rel(a, b):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    quiet = {"show_info": lambda m: None}
    print("phase 8: F5TTS(device='cuda') with its own defaults (fp32 weights)")
    tts = F5TTS(vocab_file=str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"))
    redraw_zero_init(tts.ema_model.params, seed=1)
    leaves = {t.dtype for t in _tensors(tts.ema_model.params) if t.is_floating_point()}
    if leaves != {torch.float32}:
        fail(f"F5TTS() without compute_dtype holds {leaves}, expected fp32 weights")
    per = len(chunks) * STEPS * DEPTH
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_prefix_f32=per, ff_block_f32=per,
                grouped_conv_f32=2 * STEPS * len(chunks))
    specs, wavs, counts = {}, {}, None
    tf32_was = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            reset_launch_counts()
            t0 = time.perf_counter()
            wav, sr_out, spec = tts.infer(ref_path, REF_TEXT, GEN_TEXT, nfe_step=STEPS, seed=3,
                                          **quiet)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
            rms = float(np.sqrt(np.mean(np.square(wav))))
            print(f"  cuDNN TF32 convolutions {'on (the default)' if tf32 else 'off'}: {secs:.2f} "
                  f"s, {wav.size} samples (expected {want_samples}) = {wav.size / sr_out:.2f} s "
                  f"of audio, rms {rms:.4f}; launches "
                  f"{ {k: v for k, v in counts.items() if v} } [{card}]")
            if (wav.size != want_samples or sr_out != SR or not np.isfinite(wav).all()
                    or rms <= 0 or spec.shape != (100, frames)):
                fail("fp32 offline inference: wrong length, rate or silent audio")
            if counts != want:
                fail(f"fp32 offline inference: expected launches {want}")
            specs[tf32], wavs[tf32] = spec, wav
        ref_audio, ref_text = utils_infer.preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
        _, _, spec_plain = utils_infer.infer_process(
            ref_audio, ref_text, GEN_TEXT, tts.ema_model, tts.vocoder, tts.mel_spec_type,
            nfe_step=STEPS, seed=3, kernels=False, **quiet)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_was
    err = rel(specs[False], spec_plain)
    print(f"  fp32 mel, kernels vs the same path's plain versions (cuDNN TF32 off): rel "
          f"{err:.3e} (bound {F32_REL:.0e}: fp32 sums in another order, nothing rounded below "
          f"fp32); fp32 vs the bf16 weights' mel: "
          f"{rel(specs[False], spec_bf16):.3e} (printed, not gated)")
    # the one cuDNN convolution of this path is Vocos's input convolution (conv-pos is
    # kernel C, the depthwise convolutions are shifted multiply-adds): the mel cannot move
    print(f"  cuDNN's TF32 convolutions on (PyTorch's default) vs off: mel rel "
          f"{rel(specs[True], specs[False]):.3e}, waveform rel {rel(wavs[True], wavs[False]):.3e} "
          "(printed, not gated)")
    if err > F32_REL:  # a single-pass TF32 product or a bf16-rounded p would show as ~1e-3
        fail("fp32 offline inference disagrees with the plain versions")
    del tts

    # the card against the CPU in fp32 at a small size: full width, depth 2, 256 frames
    arch = dataclasses.replace(train_arch(), depth=2, checkpoint_activations=False)
    params_cpu = redraw_zero_init(init_dit(arch, seed=0, device="cpu"), seed=1)
    rng = np.random.default_rng(12)
    cond = torch.from_numpy(rng.standard_normal((1, 100, 100)).astype(np.float32))
    text = rng.integers(0, 2000, (1, 40))
    # the noise is handed over: a CPU generator and a CUDA one draw other numbers
    y0 = torch.from_numpy(rng.standard_normal((1, 256, 100)).astype(np.float32))
    kw = dict(steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0, y0=y0)
    mel_cpu, _ = cfm_sample(params_cpu, arch, cond, text, 250, **kw)
    reset_launch_counts()
    mel_gpu, _ = cfm_sample(_to_device(params_cpu, dev), arch, cond.to(dev), text, 250, **kw)
    torch.cuda.synchronize()
    small = launch_counts()
    err = rel(mel_gpu.cpu().numpy(), mel_cpu.numpy())
    print(f"  fp32 sampler, card (fp32 kernels) vs CPU (plain), depth 2, 250 frames, 4 steps: mel "
          f"rel {err:.3e} (bound 1e-5); launches { {k: v for k, v in small.items() if v} }")
    if err > 1e-5 or small["flash_prefix_f32"] != 8 or small["ff_block_f32"] != 8:
        fail("the fp32 sampler on the card disagrees with the CPU")
    return {name: counts[name] + small[name] for name in counts}


def offline_fp32_int8(dev, card: str, ref_path: str, chunks, want_samples: int,
                      frames: int) -> dict[str, int]:
    """int8 weights on fp32 rows, as the JAX package runs an fp32 model with
    F5_TTS_INT8: F5TTS(quantize=True) with its default fp32 weights (kernels
    5, 6, 4 and the fp32 form of A per block, C's fp32 form twice a step),
    its mel against the same path's plain versions; a batch of 2 under a
    duration mask through cfm_sample (kernel 9 for q, k, v and out per block);
    and the server's --compute_dtype float32 --quantize arguments serving one
    request. Exact launch counts, and the mels under the int8 bound of phases
    4 and 9 (5e-2)."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.api import F5TTS
    from korean_f5_tts_tpu_torch.infer import utils_infer
    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
    from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.serving import server as srv

    def rel(a, b):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def want_of(**per_kernel):
        want = dict.fromkeys(KERNELS, 0)
        want.update(per_kernel)
        return want

    quiet = {"show_info": lambda m: None}
    total = dict.fromkeys(KERNELS, 0)
    print("phase 8: F5TTS(device='cuda', quantize=True) with its default fp32 weights")
    tts = F5TTS(vocab_file=str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"), quantize=True)
    redraw_zero_init(tts.ema_model.params, seed=1)  # the AdaLN layers are never quantized
    leaves = {t.dtype for t in _tensors(tts.ema_model.params)}
    if {t.dtype for t in _tensors(tts.ema_model.params) if t.is_floating_point()} != {
            torch.float32} or torch.int8 not in leaves:
        fail(f"F5TTS(quantize=True) holds {leaves}, expected fp32 weights and int8 linears")
    per = len(chunks) * STEPS * DEPTH
    want = want_of(ln_mod_matmul_int8=per, proj_gated_residual_int8=per, ff_block_int8=per,
                   flash_prefix_f32=per, grouped_conv_f32=2 * STEPS * len(chunks))
    reset_launch_counts()
    t0 = time.perf_counter()
    wav, sr_out, spec = tts.infer(ref_path, REF_TEXT, GEN_TEXT, nfe_step=STEPS, seed=3, **quiet)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    rms = float(np.sqrt(np.mean(np.square(wav))))
    print(f"  {secs:.2f} s, {wav.size} samples (expected {want_samples}) = "
          f"{wav.size / sr_out:.2f} s of audio, rms {rms:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    if (wav.size != want_samples or sr_out != SR or not np.isfinite(wav).all() or rms <= 0
            or spec.shape != (100, frames)):
        fail("fp32 int8 offline inference: wrong length, rate or silent audio")
    if counts != want:
        fail(f"fp32 int8 offline inference: expected launches {want}")
    for name, n in counts.items():
        total[name] += n
    ref_audio, ref_text = utils_infer.preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
    _, _, spec_plain = utils_infer.infer_process(
        ref_audio, ref_text, GEN_TEXT, tts.ema_model, tts.vocoder, tts.mel_spec_type,
        nfe_step=STEPS, seed=3, kernels=False, **quiet)
    err = rel(spec, spec_plain)
    print(f"  fp32 rows, int8 weights: mel with kernels vs the same path's plain versions rel "
          f"{err:.3e} (bound 5e-2, the int8 bound of phases 4 and 9)")
    if err > 5e-2:
        fail("fp32 int8 offline inference disagrees with the plain versions")

    # a batch of 2 under a duration mask: kernel 9 takes the projections
    model = tts.ema_model
    gen = torch.Generator(device=dev).manual_seed(9)
    cond = torch.randn((2, 300, 100), generator=gen, device=dev)
    text = torch.randint(0, 2000, (2, 50), generator=gen, device=dev).cpu().numpy()
    durations = np.asarray([720, 700])
    kw = dict(steps=STEPS, cfg_strength=2.0, sway_sampling_coef=-1.0, seed=5)
    reset_launch_counts()
    out, _ = cfm_sample(model.params, model.arch, cond, text, durations, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    out_plain, _ = cfm_sample(model.params, model.arch, cond, text, durations, kernels=False,
                              **kw)
    per = STEPS * DEPTH
    want = want_of(qmatmul=4 * per, flash_prefix_f32=per, ff_block_int8=per,
                   grouped_conv_f32=2 * STEPS)
    errs = [rel(out[i, :d].cpu(), out_plain[i, :d].cpu()) for i, d in enumerate(durations)]
    print(f"  cfm_sample, fp32 rows and int8 weights, a batch of 2 under a duration mask "
          f"(durations {durations.tolist()}): kernels vs plain rel "
          f"{', '.join(f'{e:.3e}' for e in errs)} (bound 5e-2); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if not torch.isfinite(out).all() or max(errs) > 5e-2:
        fail("fp32 int8 cfm_sample under a duration mask disagrees with the plain versions")
    if counts != want:
        fail(f"fp32 int8 cfm_sample under a duration mask: expected launches {want}")
    for name, n in counts.items():
        total[name] += n
    del tts, model

    # the server's own arguments: --compute_dtype float32 --quantize, one request
    args = srv.build_parser().parse_args(["--compute_dtype", "float32", "--quantize",
                                          "--vocab_file",
                                          str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt")])
    model, vocoder = srv.load_from_arguments(args)
    redraw_zero_init(model.params, seed=1)
    sr, data = wavfile.read(ref_path)
    service = srv.TTSService(model, vocoder, max_batch=8, max_wait_us=1000)
    try:
        reset_launch_counts()
        item = service.submit({"ref_wav": data.astype(np.float32) / 32768.0, "sr": int(sr),
                               "ref_text": REF_TEXT, "target_text": "One request of an fp32 "
                               "model with int8 weights.", "seed": 13})
        if not item.event.wait(timeout=600):
            fail("the fp32 int8 service did not answer")
        counts = launch_counts()
    finally:
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()
    if item.error:
        fail(f"the fp32 int8 service: {item.error}")
    audio = np.asarray(item.result[0])
    per = STEPS * DEPTH
    want = want_of(ln_mod_matmul_int8=per, proj_gated_residual_int8=per, ff_block_int8=per,
                   flash_prefix_f32=per, grouped_conv_f32=2 * STEPS)
    print(f"  the server's --compute_dtype float32 --quantize: one request, {audio.size} samples "
          f"({audio.dtype}), peak {np.abs(audio).max()}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if audio.size < 50 * HOP or not np.abs(audio).max() > 0:
        fail("the fp32 int8 service returned no audio")
    if counts != want:
        fail(f"the fp32 int8 service: expected launches {want}")
    for name, n in counts.items():
        total[name] += n
    del model, vocoder
    torch.cuda.empty_cache()
    return total


# the fp32 entry point under each opt-in path: (label, attn_path, attn_int8,
# quantize), each run's kernels per block beyond C's fp32 form twice a step
FP32_PATHS = (
    ("linear_fused", "linear_fused", None, False),
    ("rope_in_kernel", "rope_in_kernel", None, False),
    ("qkv_kernel", "qkv_kernel", None, False),
    ("attn_int8 qk", "default", "qk", False),
    ("attn_int8 qkpv", "default", "qkpv", False),
    ("quantize, attn_int8 qk", "default", "qk", True),
)
FP32_PATH_TEXT = "One sentence for every attention path of an fp32 model."


def fp32_path_launches(attn_path: str, attn_int8: str | None, quantize: bool,
                       per: int, steps: int) -> dict[str, int]:
    """The exact launches of one utterance of an fp32 model (per: chunks x
    steps x blocks; steps: chunks x steps): the fp32 forms of the attention
    path's kernels per block, kernel B's fp32 form (or, with int8 weights,
    kernels 5, 6 and 4 on fp32 rows) per block, C's fp32 form twice a step."""
    from korean_f5_tts_tpu_torch.ops import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    attn = {"rope_in_kernel": "flash_prefix_rope_f32", "qkv_kernel": "flash_prefix_qkv_f32"}
    i8 = {"qkpv": "flash_prefix_i8_f32", "qk": "flash_prefix_i8_qk_f32"}
    want[attn.get(attn_path, i8.get(attn_int8, "flash_prefix_f32"))] = per
    if attn_int8:
        want["flash_prefix_i8_quant_f32"] = per
    if quantize:
        want.update(ln_mod_matmul_int8=per, proj_gated_residual_int8=per, ff_block_int8=per)
    else:
        want["ff_block_f32"] = per
        if attn_path == "linear_fused":
            want.update(ln_mod_matmul_f32=per, proj_gated_residual_f32=per)
    want["grouped_conv_f32"] = 2 * steps
    return want


def offline_fp32_paths(dev, card: str, ref_path: str) -> dict[str, int]:
    """F5TTS(device="cuda") with its default fp32 weights under each opt-in
    path (FP32_PATHS): one utterance each with its exact launch counts (the
    fp32 forms of 7 and 8, 18, 19, 14 with its pass; the bf16 counters
    unmoved), its mel against the same path's plain versions (fp32: F32_REL,
    nothing rounded below fp32; int8 attention: 5e-2, the int8 bound of
    phases 4 and 9), and the server's --compute_dtype float32 --attn_path
    qkv_kernel serving one request."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.api import F5TTS
    from korean_f5_tts_tpu_torch.infer import utils_infer
    from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.serving import server as srv

    def rel(a, b):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    quiet = {"show_info": lambda m: None}
    vocab = str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt")
    ref_audio, ref_text = utils_infer.preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
    total = dict.fromkeys(KERNELS, 0)
    print("phase 8: F5TTS(device='cuda') with its default fp32 weights under each opt-in "
          "attention path")
    for label, attn_path, attn_int8, quantize in FP32_PATHS:
        tts = F5TTS(vocab_file=vocab, attn_path=attn_path, attn_int8=attn_int8,
                    quantize=quantize)
        redraw_zero_init(tts.ema_model.params, seed=1)
        floats = {t.dtype for t in _tensors(tts.ema_model.params) if t.is_floating_point()}
        if floats != {torch.float32}:
            fail(f"F5TTS() ({label}) holds {floats}, expected fp32 weights")
        reset_launch_counts()
        t0 = time.perf_counter()
        wav, sr_out, spec = tts.infer(ref_path, REF_TEXT, FP32_PATH_TEXT, nfe_step=STEPS, seed=3,
                                      **quiet)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        want = fp32_path_launches(attn_path, attn_int8, quantize, STEPS * DEPTH, STEPS)
        rms = float(np.sqrt(np.mean(np.square(wav))))
        _, _, spec_plain = utils_infer.infer_process(
            ref_audio, ref_text, FP32_PATH_TEXT, tts.ema_model, tts.vocoder, tts.mel_spec_type,
            nfe_step=STEPS, seed=3, kernels=False, attn_path=attn_path, attn_int8=attn_int8,
            **quiet)
        err = rel(spec, spec_plain)
        bound_ = 5e-2 if attn_int8 else F32_REL
        print(f"  {label}: {secs:.2f} s, {wav.size} samples = {wav.size / sr_out:.2f} s of audio, "
              f"rms {rms:.4f}; mel vs the same path's plain versions rel {err:.3e} (bound "
              f"{bound_:.0e}); launches { {k: v for k, v in counts.items() if v} } [{card}]")
        if (sr_out != SR or wav.size < 50 * HOP or not np.isfinite(wav).all() or rms <= 0
                or spec.shape[0] != 100 or not np.isfinite(spec).all()):
            fail(f"fp32 offline inference ({label}): wrong rate, silent or non-finite audio")
        if counts != want:
            fail(f"fp32 offline inference ({label}): expected launches "
                 f"{ {k: v for k, v in want.items() if v} }")
        if err > bound_:
            fail(f"fp32 offline inference ({label}) disagrees with the same path's plain versions")
        for name, n in counts.items():
            total[name] += n
        del tts
        torch.cuda.empty_cache()

    args = srv.build_parser().parse_args(["--compute_dtype", "float32", "--attn_path",
                                          "qkv_kernel", "--vocab_file", vocab])
    model, vocoder = srv.load_from_arguments(args)
    redraw_zero_init(model.params, seed=1)
    sr, data = wavfile.read(ref_path)
    service = srv.TTSService(model, vocoder, max_batch=8, max_wait_us=1000,
                             attn_path=args.attn_path)
    try:
        reset_launch_counts()
        item = service.submit({"ref_wav": data.astype(np.float32) / 32768.0, "sr": int(sr),
                               "ref_text": REF_TEXT, "target_text": FP32_PATH_TEXT, "seed": 13})
        if not item.event.wait(timeout=600):
            fail("the fp32 qkv_kernel service did not answer")
        counts = launch_counts()
    finally:
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()
    if item.error:
        fail(f"the fp32 qkv_kernel service: {item.error}")
    audio = np.asarray(item.result[0])
    want = fp32_path_launches("qkv_kernel", None, False, STEPS * DEPTH, STEPS)
    print(f"  the server's --compute_dtype float32 --attn_path qkv_kernel: one request, "
          f"{audio.size} samples, peak {np.abs(audio).max()}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if audio.size < 50 * HOP or not np.abs(audio).max() > 0:
        fail("the fp32 qkv_kernel service returned no audio")
    if counts != want:
        fail(f"the fp32 qkv_kernel service: expected launches {want}")
    for name, n in counts.items():
        total[name] += n
    del model, vocoder, service
    torch.cuda.empty_cache()
    return total


def profile_fp32_chunks(profile: Path) -> None:
    """One fp32 utterance chunk (F5TTS(device="cuda") with its default fp32
    weights, FP32_PATH_TEXT: one chunk) under the profiler on the default
    attn_path, on linear_fused, on qkv_kernel and on the default path with
    attn_int8 "qk": the device time of each and its kernels by device time
    (the fp32 forms of A, B, C, 7, 8, 19, 14 "qk" and its pass), tables to
    profile's .fp32.<attn_path> (.fp32.attn_int8_qk) siblings. Not gated.
    The entry points are those of any tree since fp32 models ran every
    attn_path and attn_int8, so a parent's package times the same way."""
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.api import F5TTS
    from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init

    quiet = {"show_info": lambda m: None}
    vocab = str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt")
    with tempfile.TemporaryDirectory() as tmp:
        t = np.arange(int(3.0 * SR)) / SR
        ref_path = str(Path(tmp) / "ref.wav")
        wavfile.write(ref_path, SR, (0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * t) * t)
                                     * 32767).astype(np.int16))
        for attn_path, attn_int8 in (("default", None), ("linear_fused", None),
                                     ("qkv_kernel", None), ("default", "qk")):
            tts = F5TTS(vocab_file=vocab, attn_path=attn_path, attn_int8=attn_int8)
            redraw_zero_init(tts.ema_model.params, seed=1)
            label = f"attn_int8_{attn_int8}" if attn_int8 else attn_path
            busy = profile_once(
                lambda: tts.infer(ref_path, REF_TEXT, FP32_PATH_TEXT, nfe_step=STEPS, seed=3,
                                  **quiet),
                profile.with_suffix(f".fp32.{label}.txt"),
                f"one fp32 utterance chunk, {label}")
            print(f"phase 8: an fp32 utterance chunk on {label}: {busy:.2f} ms of device time")
            del tts
            torch.cuda.empty_cache()


def phase8_offline(dev, card: str) -> dict[str, int]:
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.api import F5TTS
    from korean_f5_tts_tpu_torch.infer import utils_infer
    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
    from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts

    print("phase 8: the offline entry point, F5TTS(F5TTS_v1_Base, device='cuda', bf16).infer "
          "(fp32 reference mel: the fp32 forms on the bf16 weights)")
    total = dict.fromkeys(KERNELS, 0)
    nfe = STEPS
    with tempfile.TemporaryDirectory() as tmp:
        t = np.arange(int(3.0 * SR)) / SR
        ref_path = str(Path(tmp) / "ref.wav")
        wavfile.write(ref_path, SR, (0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * t) * t)
                                     * 32767).astype(np.int16))
        # what infer() will do with this reference and text, worked out beforehand
        (ref_wav, sr), ref_text = utils_infer.preprocess_ref_audio_text(ref_path, REF_TEXT,
                                                                       show_info=lambda m: None)
        ref_frames = len(ref_wav) // HOP + 1
        max_chars = int(len(ref_text.encode()) / (len(ref_wav) / sr) * (22 - len(ref_wav) / sr))
        chunks = utils_infer.chunk_text(GEN_TEXT, max_chars=max_chars)
        sizes = [len(c.encode()) for c in chunks]
        print(f"  reference {len(ref_wav) / sr:.2f} s, {ref_frames} frames; {len(chunks)} chunks "
              f"of {sizes} bytes (max_chars {max_chars})")
        if len(chunks) < 3 or len(set(sizes)) < 2:
            fail("the text did not split into three or more unequal chunks")
        ref_bytes = len(ref_text.encode()) + 1  # infer_batch_process appends a space
        gen_frames = [int(ref_frames / ref_bytes * n) for n in sizes]
        fade = int(0.15 * SR)
        # the vocoder's ISTFT gives (frames - 1) * hop samples per chunk; the
        # chunks are joined with a 0.15 s cross-fade
        want_samples = sum((g - 1) * HOP for g in gen_frames) - fade * (len(chunks) - 1)

        for path in ("default", "qkv_kernel"):
            tts = F5TTS("F5TTS_v1_Base", device="cuda", compute_dtype=torch.bfloat16,
                        vocab_file=str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"),
                        attn_path=path)
            redraw_zero_init(tts.ema_model.params, seed=1)
            runs = [("CFG 2", 2.0)] + ([("no CFG", 0.0)] if path == "default" else [])
            for label, cfg_strength in runs:
                out_path = str(Path(tmp) / f"out_{path}_{cfg_strength}.wav")
                reset_launch_counts()
                t0 = time.perf_counter()
                wav, sr_out, spec = tts.infer(ref_path, REF_TEXT, GEN_TEXT, nfe_step=nfe,
                                              cfg_strength=cfg_strength, seed=3,
                                              file_wave=out_path, show_info=lambda m: None)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = launch_counts()
                per = len(chunks) * nfe * DEPTH
                attn = "flash_prefix_qkv" if path == "qkv_kernel" else "flash_prefix"
                want = dict.fromkeys(KERNELS, 0)
                # without CFG a step is dit_forward, whose FF half-block is plain
                # products (as in the JAX package): kernel B does not run. The
                # reference mel is fp32, so the bf16 weights run the fp32 forms
                want.update({attn: per, "grouped_conv": 2 * nfe * len(chunks),
                             "ff_block": per if cfg_strength > 0 else 0})
                want = on_fp32_rows(want)
                sr_file, wav_file = wavfile.read(out_path)
                rms = float(np.sqrt(np.mean(np.square(wav))))
                print(f"  {path}, {label}: {secs:.2f} s, {wav.size} samples (expected "
                      f"{want_samples}) at {sr_out} Hz = {wav.size / sr_out:.2f} s of audio, rms "
                      f"{rms:.4f}, spectrogram {spec.shape}; launches {counts} [{card}]")
                if (wav.size != want_samples or sr_out != SR or sr_file != SR
                        or wav_file.size != wav.size or not np.isfinite(wav).all() or rms <= 0
                        or spec.shape != (100, sum(gen_frames))):
                    fail(f"offline inference ({path}, {label}): wrong length, rate or silent audio")
                if counts != want:
                    fail(f"offline inference ({path}, {label}): expected launches {want}")
                for name, n in counts.items():
                    total[name] += n
                if path == "default" and cfg_strength > 0:
                    spec_bf16 = spec
            model = tts.ema_model
            del tts
        for name, n in offline_fp32(dev, card, ref_path, chunks, want_samples,
                                    sum(gen_frames), spec_bf16).items():
            total[name] += n
        for name, n in offline_fp32_int8(dev, card, ref_path, chunks, want_samples,
                                         sum(gen_frames)).items():
            total[name] += n
        for name, n in offline_fp32_paths(dev, card, ref_path).items():
            total[name] += n
        # cfm_sample on a batch of 3 in two duration buckets (768 and 1024 frames)
        gen = torch.Generator(device=dev).manual_seed(8)
        cond = torch.randn((3, 300, 100), generator=gen, device=dev)
        text = torch.randint(0, 2000, (3, 50), generator=gen, device=dev).cpu().numpy()
        durations = np.asarray([720, 720, 1000])
        for path in ("rope_in_kernel", "qkv_kernel"):
            reset_launch_counts()
            out, _ = cfm_sample(model.params, model.arch, cond, text, durations, steps=nfe,
                                cfg_strength=2.0, sway_sampling_coef=-1.0, seed=5,
                                attn_path=path)
            torch.cuda.synchronize()
            counts = launch_counts()
            attn = "flash_prefix_rope" if path == "rope_in_kernel" else "flash_prefix_qkv"
            want = dict.fromkeys(KERNELS, 0)  # two groups, each nfe steps of 22 blocks
            want.update({attn: 2 * nfe * DEPTH, "ff_block": 2 * nfe * DEPTH,
                         "grouped_conv": 2 * 2 * nfe})
            want = on_fp32_rows(want)  # fp32 cond beside the bf16 weights
            errs = []
            for i, dur in enumerate(durations):
                alone, _ = cfm_sample(model.params, model.arch, cond[i:i + 1], text[i:i + 1],
                                      int(dur), steps=nfe, cfg_strength=2.0,
                                      sway_sampling_coef=-1.0, seed=5, attn_path=path)
                errs.append(_rel(out[i, :dur], alone[0, :dur]))
            print(f"  cfm_sample batch of 3, durations {durations.tolist()} ({path}): out "
                  f"{tuple(out.shape)}, each item vs the same item alone rel err "
                  f"{', '.join(f'{e:.3e}' for e in errs)} (bound 5e-2); launches {counts}")
            if tuple(out.shape) != (3, 1024, 100) or not torch.isfinite(out).all():
                fail("cfm_sample: wrong shape or non-finite mel")
            if out[:2, 768:].abs().max().item() != 0:
                fail("cfm_sample: the group of 2 did not run at its own 768-frame bucket")
            if max(errs) > 5e-2:
                fail("cfm_sample: a batched item disagrees with the same item sampled alone")
            if counts != want:
                fail(f"cfm_sample ({path}): expected launches {want}")
            for name, n in counts.items():
                total[name] += n
        for name, n in bf16_weights_on_fp32_cond(model, nfe).items():
            total[name] += n
    del model
    torch.cuda.empty_cache()
    return total


def bf16_weights_on_fp32_cond(model, nfe: int) -> dict[str, int]:
    """cfm_sample with F5TTS_v1_Base's bf16 weights on fp32 cond, one
    utterance (cond 300, duration 1000, bucket 128: 1024 frames, CFG 2, sway
    -1): every kernel's fp32 form, launches exact, the mel against the same
    call's plain versions within F32_REL (fp32 activations on the weights
    widened once: nothing rounds below fp32 but the weights and the text
    embedding, alike on both sides)."""
    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts

    gen = torch.Generator(device=model.device).manual_seed(9)
    cond = torch.randn((1, 300, 100), generator=gen, device=model.device)
    text = torch.randint(0, 2000, (1, 60), generator=gen, device=model.device).cpu().numpy()
    kw = dict(steps=nfe, cfg_strength=2.0, sway_sampling_coef=-1.0, seed=5)
    reset_launch_counts()
    mel_k, _ = cfm_sample(model.params, model.arch, cond, text, 1000, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    mel_p, _ = cfm_sample(model.params, model.arch, cond, text, 1000, kernels=False, **kw)
    want = launches_of(flash_prefix_f32=nfe * DEPTH, ff_block_f32=nfe * DEPTH,
                       grouped_conv_f32=2 * nfe)
    err = _rel(mel_k[:, :1000], mel_p[:, :1000])
    print(f"  cfm_sample, bf16 weights on fp32 cond (cond 300, duration 1000): mel "
          f"{str(mel_k.dtype).removeprefix('torch.')} {tuple(mel_k.shape)}, kernels vs plain rel "
          f"{err:.3e} (bound {F32_REL:.0e}); launches {({k: v for k, v in counts.items() if v})}")
    if mel_k.dtype != torch.float32 or not torch.isfinite(mel_k).all():
        fail("cfm_sample on fp32 cond beside bf16 weights: not an fp32 mel, or not finite")
    if err > F32_REL or not np.isfinite(err):
        fail("cfm_sample on fp32 cond beside bf16 weights disagrees with its plain versions")
    if counts != want:
        fail(f"cfm_sample on fp32 cond beside bf16 weights: launches {counts}, expected {want}")
    return counts


# ---------------------------------------------------------------------------
# phase 9: int8 attention and the rest of serving and inference
# ---------------------------------------------------------------------------

INT8_ATTN_MODES = ("qk", "qkpv")
# A two-call path against the fused one on the same request, over the
# samples more than 32 frames from either end of the generated audio: the
# same weights on the same seeded noise, but the two-call path's cfm_sample
# keeps the reference mel's fp32 (fp32 rows) where the fused path runs
# all-bf16, the reference mel is computed unpadded on one side and in a
# padded bucket on the other, the second vocoder call sees only the
# generated frames (the fused decode the whole utterance), and the fused
# path rounds to int16.
TWO_CALL_REL = 5e-2


def phase9_int8_attention(dev, card: str, profile: Path | None = None) -> dict[str, int]:
    """int8 attention and the rest of serving and inference at full width
    (F5TTS_v1_Base, depth 22, Vocos): the server through warm_start + serve
    with int8 weights and int8 attention;
    the bench-protocol mel, RTF and mel MAE of the four int8-attention modes;
    the two-call serving paths; the gRPC handler bodies and the socket
    server; both serving benchmarks; speech edit and batch generation.
    Returns the launch counts of the served requests."""
    import base64
    import io
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch import socket_server
    from korean_f5_tts_tpu_torch.infer import batch_infer, speech_edit
    from korean_f5_tts_tpu_torch.models.vocos import vocos_decode
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.serving import benchmark, grpc_server
    from korean_f5_tts_tpu_torch.serving import proto as pb
    from korean_f5_tts_tpu_torch.serving import server as srv

    models = {"bf16": build_model(dev), "int8": build_model(dev, quantize=True)}
    model, vocoder = models["int8"]

    # (a) the server, warmed, with int8 weights and int8 attention
    counts = phase3_serve(model, vocoder, "int8", attn_int8="qkpv", warm=True)

    # (b) the four int8-attention modes at the bench protocol
    inputs = bench_inputs(dev)
    total = 1376

    def rel(a, b):
        a, b = a[:, :total].float(), b[:, :total].float()
        return ((a - b).norm() / b.norm()).item()

    def mae(a, b):
        return (a[:, :total].float() - b[:, :total].float()).abs().mean().item()

    mel_bf16, _ = synthesize(*models["bf16"], inputs)
    scale = mel_bf16[:, :total].float().abs().mean().item()
    rtfs = {"int8 weights, bf16 attention": phase5_rtf(model, vocoder, dev, card, "int8",
                                                       plain=False)}
    mel_int8, _ = synthesize(model, vocoder, inputs)
    print(f"phase 9: mel MAE against the bf16 sampler (mean |mel| {scale:.4f}): int8 weights, "
          f"bf16 attention {mae(mel_int8, mel_bf16):.5f} ({mae(mel_int8, mel_bf16) / scale:.5f} "
          "relative)")
    for weights in ("bf16", "int8"):
        m, v = models[weights]
        for attn in INT8_ATTN_MODES:
            mel_k, wav_k = synthesize(m, v, inputs, attn_int8=attn)
            mel_p, _ = synthesize(m, v, inputs, kernels=False, attn_int8=attn)
            torch.cuda.synchronize()
            if not (torch.isfinite(mel_k).all() and torch.isfinite(wav_k).all()):
                fail(f"{weights} weights, attn_int8 {attn}: non-finite mel or waveform")
            err = rel(mel_k, mel_p)
            print(f"phase 9 ({weights} weights, attn_int8 {attn}): bench-protocol mel rel err, "
                  f"kernels vs plain {err:.3e} (bound 5e-2); mel MAE against the bf16 sampler "
                  f"{mae(mel_k, mel_bf16):.5f} ({mae(mel_k, mel_bf16) / scale:.5f} relative)")
            if err > 5e-2:
                fail(f"{weights} weights, attn_int8 {attn}: the sampler with kernels disagrees "
                     "with the plain versions")
            rtfs[f"{weights} weights, attn_int8 {attn}"] = phase5_rtf(
                m, v, dev, card, weights, plain=False, attn_int8=attn)
    print("phase 9: RTF (bench protocol, kernels): "
          + ", ".join(f"{k} {v:.5f}" for k, v in rtfs.items()) + f" [{card}]")
    if profile is not None:
        profile_once(lambda: synthesize(model, vocoder, inputs, attn_int8="qkpv"),
                     profile.with_suffix(".attn_int8.txt"), "int8 weights, attn_int8 qkpv")
    del models["bf16"]

    # (c) a callable vocoder: _synthesize for one request, _synthesize_batch for two
    ref_b64, ref_samples = chirp_wav_b64(3.0)
    sr, data = wavfile.read(io.BytesIO(base64.b64decode(ref_b64)))
    ref_wav = data.astype(np.float32) / 32768.0
    targets = ["One request served by the two-call path.",
               "The first of a pair in one batch.", "The second of that pair, in a batch."]

    def payload(target):
        return {"ref_wav": ref_wav.copy(), "sr": int(sr), "ref_text": REF_TEXT,
                "target_text": target, "seed": 13}

    def plain_vocoder(mel):  # a callable without .params: fp32 mel on the model's device in
        return vocos_decode(vocoder.params, mel.to(torch.bfloat16), vocoder.vcfg)

    fast = srv.TTSService(model, vocoder, max_batch=8, max_wait_us=300_000, attn_int8="qkpv")
    two_call = srv.TTSService(model, plain_vocoder, max_batch=8, max_wait_us=300_000,
                              attn_int8="qkpv")
    try:
        if two_call.vocoder_fused is not None:
            fail("a plain callable vocoder was taken for a fused one")
        want = []
        for group in (targets[:1], targets[1:]):
            items = [srv._Pending(payload(t)) for t in group]
            fast._synthesize_fast(items)
            want += [it.result[0].astype(np.float32) / 32768.0 for it in items]
        reset_launch_counts()
        first = two_call.submit(payload(targets[0]))
        if not first.event.wait(timeout=600):
            fail("the two-call service did not answer")
        pair = [two_call.submit(payload(t)) for t in targets[1:]]
        for it in pair:
            if not it.event.wait(timeout=600):
                fail("the two-call service did not answer a batched request")
        c_counts = launch_counts()
        sizes = two_call.stats["batch_sizes"]
        if sorted(sizes) != [1, 2]:
            fail(f"two-call service: expected one batch of 1 and one of 2, got {sizes}")
        # _synthesize: cfm_sample at batch 1 (kernels 5, 14, 6, 4); the batch of
        # 2 carries a duration mask (kernel 9 per projection, 14, 4); fp32 rows:
        # cfm_sample keeps the reference mel's fp32
        c_want = on_fp32_rows(expected_launches("int8", 2, attn_int8="qkpv"), "qkpv")
        print(f"phase 9 (callable vocoder): batches {sizes}; launches {c_counts} (expected "
              f"{c_want})")
        if c_counts != c_want:
            fail("the two-call paths did not run the kernels their batches require")
        edge = 32 * HOP
        for name, item, ref in zip(("_synthesize", "_synthesize_batch[0]", "_synthesize_batch[1]"),
                                   [first, *pair], want):
            if item.error:
                fail(f"{name}: {item.error}")
            got = np.asarray(item.result[0], np.float32)
            # one request alone decodes its generated frames by themselves: the
            # ISTFT of n frames gives (n - 1) * hop samples
            size = ref.size - HOP if name == "_synthesize" else ref.size
            if got.shape != (size,) or not np.isfinite(got).all() or size <= 4 * edge:
                fail(f"{name}: {got.shape} samples, the fused path gave {ref.shape}")
            g, w = got[edge:-edge], ref[edge:size - edge]
            err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
            print(f"  {name}: {got.size} samples, rel err to the fused path's audio for the same "
                  f"request {err:.3e} over the interior (bound {TWO_CALL_REL:.0e})")
            if err > TWO_CALL_REL:
                fail(f"{name} disagrees with the fused path")

        # (d) the gRPC handler bodies on proto bytes, and the socket server
        if pb.decode_ready_response(grpc_server.server_ready(fast, b"")) is not True:
            fail("server_ready did not answer ready")
        if json.loads(grpc_server.health(fast, b"{}")) != {"status": "ok"}:
            fail("health did not answer ok")
        req = grpc_server.encode_infer_request("f5_tts", ref_wav, REF_TEXT, targets[0], "7")
        t0 = time.perf_counter()
        resp = pb.decode_model_infer_response(grpc_server.model_infer(fast, req))
        wave = np.asarray(resp["outputs"]["waveform"], np.float32).reshape(-1)
        want_n = expected_samples(ref_samples, targets[0])
        body = json.dumps({"reference_audio": ref_b64, "reference_text": REF_TEXT,
                           "target_text": targets[1], "seed": 13}).encode()
        out = json.loads(grpc_server.synthesize(fast, body))
        _, audio = wavfile.read(io.BytesIO(base64.b64decode(out["audio"])))
        print(f"phase 9 (gRPC handler bodies, no grpc import): ModelInfer id {resp['id']} -> "
              f"{wave.size} FP32 samples (expected {want_n}), peak {np.abs(wave).max():.3f}; "
              f"Synthesize -> {audio.size} int16 samples (expected "
              f"{expected_samples(ref_samples, targets[1])}); {time.perf_counter() - t0:.2f} s")
        if (resp["id"] != "7" or wave.size != want_n or not np.isfinite(wave).all()
                or not 0 < np.abs(wave).max() <= 1.0 or audio.dtype != np.int16
                or audio.size != expected_samples(ref_samples, targets[1])):
            fail("a gRPC handler body gave a wrong waveform")
    finally:
        for service in (fast, two_call):
            service.shutdown(drain=False, timeout=5.0)
            service.batcher.close()

    with tempfile.TemporaryDirectory() as tmp:
        ref_path = str(Path(tmp) / "ref.wav")
        wavfile.write(ref_path, SR, data)
        processor = socket_server.TTSStreamingProcessor(model, vocoder, ref_path, REF_TEXT,
                                                        nfe_step=STEPS, attn_int8="qkpv")
        ready, stop, port = threading.Event(), threading.Event(), []
        thread = threading.Thread(target=socket_server.start_server, daemon=True, kwargs=dict(
            processor=processor, host="127.0.0.1", port=0, stop=stop,
            ready=lambda p: (port.append(p), ready.set())))
        thread.start()
        try:
            if not ready.wait(timeout=60):
                fail("the socket server did not come up")
            t0 = time.perf_counter()
            with socket.create_connection(("127.0.0.1", port[0]), timeout=600) as conn:
                conn.sendall(targets[0].encode())
                stream = b""
                while not stream.endswith(b"END"):
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        fail("the socket server closed before the END sentinel")
                    stream += chunk
            pcm = np.frombuffer(stream[:-3], np.float32)
            print(f"phase 9 (socket server): {pcm.size} float32 samples streamed in "
                  f"{time.perf_counter() - t0:.2f} s, rms {np.sqrt(np.mean(pcm ** 2)):.4f}")
            if pcm.size < 100 * HOP or not np.isfinite(pcm).all() or np.abs(pcm).max() == 0:
                fail("the socket server streamed no audio")
        finally:
            stop.set()
            thread.join(timeout=10)

        # (e) the serving benchmarks run and measure something; 3 items are no
        # latency distribution (python -m ...serving.benchmark measures 26)
        for name, run in (("latency", benchmark.run_latency_benchmark),
                          ("offline", benchmark.run_offline_benchmark)):
            for attn in (None, "qkpv"):
                result = run(model, vocoder, n_items=3, nfe_step=STEPS, warmup=1, attn_int8=attn)
                print(f"phase 9 (serving benchmark, {name}, 3 items, int8 weights, "
                      f"attn_int8 {attn}) [{card}]:")
                print(json.dumps(result))
                timed = result["latency_avg_ms"] if name == "latency" else result["rtf"]
                if not (np.isfinite(timed) and timed > 0):
                    fail(f"the {name} benchmark measured nothing")

        # (f) speech edit and batch generation
        wav = ref_wav
        span = (1.0, 1.8)
        mel_in = model.mel_of_wav(wav)
        edited = speech_edit.edit_speech(model, wav, REF_TEXT, "This is the edited speech.",
                                         [span], nfe_step=STEPS, seed=2, attn_int8="qkpv")
        lo, hi = int(span[0] * SR / HOP), int(span[1] * SR / HOP)
        kept = np.concatenate([edited[:lo], edited[hi:]])
        kept_in = np.concatenate([mel_in[:lo], mel_in[hi:]])
        # the kept frames are cond spliced back at its own fp32: the input mel
        kept_err = float(np.abs(kept - kept_in).max())
        moved = float(np.abs(edited[lo:hi] - mel_in[lo:hi]).mean())
        print(f"phase 9 (edit_speech): mel {edited.shape} from {mel_in.shape}, span frames "
              f"[{lo}, {hi}); kept frames differ from the input mel by at most {kept_err:.3e} "
              f"(bound 1e-6: cond's fp32 spliced back), edited frames by {moved:.3f} on average")
        if (edited.shape != mel_in.shape or not np.isfinite(edited).all() or kept_err > 1e-6
                or moved < 0.1):
            fail("edit_speech: wrong shape, or the kept span is not the input mel")
        rows = [{"utt": "row_a", "text": "The first row of the batch."},
                {"utt": "row_b", "text": "And the second row, a little longer than the first!"}]
        written = batch_infer.batch_generate(model, vocoder, rows, str(Path(tmp) / "out"),
                                             ref_audio=ref_path, ref_text=REF_TEXT,
                                             nfe_step=STEPS, seed=4, attn_int8="qkpv")
        sizes = []
        for path in written:
            sr_out, audio = wavfile.read(path)
            sizes.append(audio.size)
            if sr_out != SR or audio.size < 50 * HOP or not np.abs(audio).max() > 0:
                fail(f"batch_generate: {path} holds no audio")
        print(f"phase 9 (batch_generate): {[Path(p).name for p in written]} with {sizes} samples")
        if [Path(p).name for p in written] != ["row_a.wav", "row_b.wav"] or sizes[0] >= sizes[1]:
            fail("batch_generate did not write one wav per row")
    del models, model, vocoder
    torch.cuda.empty_cache()
    return counts


def profile_once(run, path: Path | None, label: str, top: int = 25) -> float:
    """run() (one bench-protocol utterance, or one training step) under
    torch.profiler: device busy time (device-side kernel events only), its
    share of the un-profiled wall time (mean of 3), and the `top` kernels by
    device time; the whole table goes to path when one is given. Returns the
    device busy time in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile ({label}): wall {wall_ms:.2f} ms (un-profiled, mean of 3), device busy "
          f"{busy_ms:.2f} ms in {sum(e.count for e in kernels)} kernel launches, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; kernels by device time:")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(prof.key_averages().table(sort_by="self_device_time_total",
                                                  row_limit=80))
        print(f"  full table: {path}")
    return busy_ms


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_N = 8, 1280  # the JAX package's training A/B shape (flash_prefix.py:1258)
TRAINER_DEPTH = 4  # the Trainer run's depth: its checkpoint is 1/5 of depth 22's 5 GiB
TRAIN_REL = 5e-2
# device busy time of one step, and of its conv-pos convolutions, while those ran in fp32
PARENT_TRAIN_STEP_MS, PARENT_TRAIN_CONV_MS = 251.13, 43.7


def expected_train_launches(steps: int, depth: int = DEPTH, f32: bool = False) -> dict[str, int]:
    """Launches of `steps` training steps with full remat: per block, kernel
    10 in the forward and again in the backward's recompute, 11 and 13 once
    in the backward, in the bf16 forms or (f32) the fp32 ones; nothing else
    (conv-pos is plain tensor code under autograd, the FF half-block is plain
    products)."""
    from korean_f5_tts_tpu_torch.ops import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    tag = "_f32" if f32 else ""
    want.update({f"flash_prefix_lse{tag}": 2 * depth * steps,
                 f"flash_prefix_dq_lsein{tag}": depth * steps,
                 f"flash_prefix_dkv{tag}": depth * steps})
    return want


def drive_attention_bwd(dev, lens, dtype, d: int = 64) -> dict[str, int]:
    """The attention backward's own entry point at the training shape:
    flash_prefix_attention_bwd without the forward's lse (the JAX contract,
    flash_prefix.py:1246-1297) runs kernel A for o, kernel 12 for dq and the
    lse, and kernel 13, in the forms of `dtype` (bf16 or fp32) and of head
    dim d (64: 16 heads; 128: 8). Counted on its own; held against autograd
    of the plain attention (relative L2: the Function's bound 2e-2 in bf16,
    F32_GRAD_REL in fp32)."""
    import torch

    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, g = (torch.randn((TRAIN_B, 1024 // d, TRAIN_N, d), generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    reset_launch_counts()
    got = fp.flash_prefix_attention_bwd(q, k, v, lens, g)
    torch.cuda.synchronize()
    counts = launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fp.flash_prefix_attention(*leaves, lens, kernels=False),
                               leaves, g)
    errs = [_rel(a, b) for a, b in zip(got, want)]
    f32 = dtype == torch.float32
    rel_bound = F32_GRAD_REL if f32 else 2e-2
    print(f"  flash_prefix_attention_bwd(lse=None) on {dtype}, b {TRAIN_B} x {1024 // d} heads "
          f"of {d}, n "
          f"{TRAIN_N}, kv {lens.tolist()}: dq/dk/dv rel_err "
          f"{', '.join(f'{e:.3e}' for e in errs)} (bound {rel_bound:.0e})")
    if not all(torch.isfinite(t).all() and t.dtype == dtype for t in got) or \
            max(errs) > rel_bound:
        fail(f"flash_prefix_attention_bwd on {dtype} disagrees with the plain backward")
    expected = dict.fromkeys(KERNELS, 0)
    tag = ("_f32" if f32 else "") + ("_d128" if d == 128 else "")
    expected.update({f"flash_prefix{tag}": 1, f"flash_prefix_dq{tag}": 1,
                     f"flash_prefix_dkv{tag}": 1})
    print(f"  its launches: {counts} (expected {expected})")
    if counts != expected:
        fail(f"flash_prefix_attention_bwd on {dtype} did not run kernels A, 12 and 13 once each")
    return counts


TRAIN_F32_DEPTH = DEPTH  # the fp32 step against the plain versions: full width and depth
CPU_STEP_SEEDS = (7, 17, 27)  # the fp32 step at depth 2 against the CPU, one draw a seed


def phase6_fp32_step(dev, arch, params, batch) -> None:
    """The fp32 training step (compute_dtype None, the Trainer's and
    train_step's default): one step's loss and whole gradient with kernels
    (the fp32 forms of 10, 11, 13, exact launch counts) against the plain
    versions at full width and depth TRAIN_F32_DEPTH, then the same step at
    depth 2 on the card against the CPU with the same draws (dropout off),
    once for each of CPU_STEP_SEEDS, all at F32_GRAD_REL. The card step runs with PyTorch's own TF32
    defaults, as a user's process has them: cuDNN's switch on, so conv-pos's
    convolution under autograd runs in TF32; the same step with that switch
    off is printed beside it, which shows what TF32 costs there."""
    import dataclasses

    import torch

    from korean_f5_tts_tpu_torch.models.cfm import draw_cfm
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.train.step import loss_and_grads

    def rel_pair(a, b):
        (la, ga), (lb, gb) = a, b
        flat_a = torch.cat([g.flatten().float().cpu() for g in ga])
        flat_b = torch.cat([g.flatten().float().cpu() for g in gb])
        ok = bool(torch.isfinite(flat_a).all())
        return abs(la.item() - lb.item()) / abs(lb.item()), _rel(flat_a, flat_b), ok

    reset_launch_counts()
    got = loss_and_grads(params, batch, 5, arch)  # compute_dtype None: fp32
    torch.cuda.synchronize()
    counts = launch_counts()
    want = expected_train_launches(1, arch.depth, f32=True)
    print(f"  fp32 step (compute_dtype None), depth {arch.depth}: launches {counts} (expected "
          f"{want})")
    if counts != want:
        fail("the fp32 training step did not run the fp32 forms of 10, 11, 13 as often as it "
             "requires")
    plain = loss_and_grads(params, batch, 5, arch, kernels=False)
    loss_err, grad_err, ok = rel_pair(got, plain)
    print(f"  fp32 step, kernels against plain: loss {got[0].item():.7f} / "
          f"{plain[0].item():.7f} (rel {loss_err:.3e}), gradient rel L2 {grad_err:.3e} (bound "
          f"{F32_GRAD_REL:.0e} each)")
    if not ok or loss_err > F32_GRAD_REL or grad_err > F32_GRAD_REL:
        fail("the fp32 training step with kernels disagrees with the plain versions")
    del got, plain

    small = dataclasses.replace(arch, depth=2)
    t0 = time.perf_counter()
    worst = []
    for seed in CPU_STEP_SEEDS:  # weights from seed, their zero layers from seed + 1,
        # draws from seed + 2; one draw alone left little room under the bound
        p2 = redraw_zero_init(init_dit(small, seed=seed, device=dev), seed=seed + 1)
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        draws = draw_cfm(tuple(batch["mel"].shape), batch["lens"], gen)

        def on(device):
            to = lambda tree: {k: to(v) for k, v in tree.items()} if isinstance(tree, dict) \
                else ([to(v) for v in tree] if isinstance(tree, list) else tree.to(device))
            return to(p2), {k: v.to(device) for k, v in batch.items()}, \
                {k: v.to(device) for k, v in draws.items()}

        p_cpu, batch_cpu, draws_cpu = on("cpu")
        cpu = loss_and_grads(p_cpu, batch_cpu, 5, small, draws=draws_cpu)
        exact = loss_and_grads(p2, batch, 5, small, draws=draws)  # cuDNN's TF32 off
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as a user's process has it
        try:
            card = loss_and_grads(p2, batch, 5, small, draws=draws)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        loss_err, grad_err, ok = rel_pair(card, cpu)
        e_loss, e_grad, _ = rel_pair(exact, cpu)
        worst.append((grad_err, e_grad))
        print(f"  fp32 step at depth 2, seed {seed}, card (cuDNN's TF32 switch on, PyTorch's "
              f"default: conv-pos convolves in TF32) against the CPU: loss rel {loss_err:.3e}, "
              f"gradient rel L2 {grad_err:.3e} (bound {F32_GRAD_REL:.0e} each); with cuDNN's "
              f"TF32 off: loss rel {e_loss:.3e}, gradient rel L2 {e_grad:.3e}")
        if not ok or loss_err > F32_GRAD_REL or grad_err > F32_GRAD_REL:
            fail(f"the fp32 training step on the card disagrees with the CPU (seed {seed})")
    on_tf32, off_tf32 = zip(*worst)
    print(f"  fp32 step at depth 2 against the CPU over seeds {list(CPU_STEP_SEEDS)}: gradient "
          f"rel L2 {min(on_tf32):.3e}-{max(on_tf32):.3e} with cuDNN's TF32 on, "
          f"{min(off_tf32):.3e}-{max(off_tf32):.3e} off (bound {F32_GRAD_REL:.0e}); "
          f"{time.perf_counter() - t0:.1f} s")


def train_arch():
    from korean_f5_tts_tpu_torch.config import PRESETS, DiTConfig

    return DiTConfig(**PRESETS["F5TTS_v1_Base"]["arch"], text_num_embeds=2545,
                     checkpoint_activations=True)


def train_batch(dev) -> dict:
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    lens = torch.randint(TRAIN_N * 3 // 4, TRAIN_N + 1, (TRAIN_B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = TRAIN_N
    text = torch.randint(1, 2545, (TRAIN_B, 256), generator=gen, device=dev, dtype=torch.int32)
    text[:, 200:] = -1
    mel = torch.randn((TRAIN_B, TRAIN_N, 100), generator=gen, device=dev)
    mel = mel.masked_fill(~(torch.arange(TRAIN_N, device=dev)[None, :, None] < lens[:, None, None]),
                          0.0)
    return {"mel": mel, "text": text, "lens": lens}


def phase6_train(dev, card: str, profile_path: Path | None = None) -> dict[str, int]:
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.data.dataset import CustomDataset
    from korean_f5_tts_tpu_torch.models.dit import count_params, init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.scripts import bench_train
    from korean_f5_tts_tpu_torch.train.step import (
        init_train_state,
        loss_and_grads,
        make_optimizer,
        train_step,
    )
    from korean_f5_tts_tpu_torch.train.trainer import Trainer

    arch = train_arch()
    params = redraw_zero_init(init_dit(arch, seed=0, device=dev), seed=1)
    print(f"phase 6: training F5TTS_v1_Base ({count_params(params) / 1e6:.1f} M params, depth "
          f"{arch.depth}, fp32 masters, bf16 compute, full remat, dropout {arch.dropout}), "
          f"batch {TRAIN_B} x {TRAIN_N}")
    batch = train_batch(dev)
    reset_launch_counts()
    loss_k, grads_k = loss_and_grads(params, batch, 5, arch, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = expected_train_launches(1)
    print(f"  launches of one step with kernels: {counts} (expected {want})")
    if counts != want:
        fail("a training kernel did not run as often as the step requires")
    loss_p, grads_p = loss_and_grads(params, batch, 5, arch, compute_dtype=torch.bfloat16,
                                     kernels=False)
    flat_k = torch.cat([g.flatten() for g in grads_k])
    flat_p = torch.cat([g.flatten() for g in grads_p])
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_err = _rel(flat_k, flat_p)
    print(f"  loss kernels {loss_k.item():.6f} plain {loss_p.item():.6f} (rel {loss_err:.3e}); "
          f"gradient rel L2 {grad_err:.3e} over {flat_p.numel()} values, |g| "
          f"{flat_p.norm().item():.4f} (bound {TRAIN_REL:.0e} each)")
    if not torch.isfinite(flat_k).all() or loss_err > TRAIN_REL or grad_err > TRAIN_REL:
        fail("the training step with kernels disagrees with the plain versions")
    del grads_k, grads_p, flat_k, flat_p
    bwd_counts = drive_attention_bwd(dev, batch["lens"], torch.bfloat16)
    f32_bwd_counts = drive_attention_bwd(dev, batch["lens"], torch.float32)
    phase6_fp32_step(dev, dataclasses.replace(arch, depth=TRAIN_F32_DEPTH), params, batch)

    # Trainer: 2 updates, checkpoint, resume, 2 more, on seeded mels, at depth 4
    small = dataclasses.replace(arch, depth=TRAINER_DEPTH)
    small_params = redraw_zero_init(init_dit(small, seed=0, device=dev), seed=1)
    rng = np.random.default_rng(4)
    frames = [int(f) for f in rng.integers(TRAIN_N - 120, TRAIN_N + 1, 2 * TRAIN_B)]
    rows = [{"mel_spec": rng.standard_normal((100, f)).astype(np.float32),
             "text": "this is a training row", "duration": f * HOP / SR} for f in frames]
    dataset = CustomDataset(rows, preprocessed_mel=True)
    vocab = {c: i + 1 for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz")}
    train_counts = {}
    # bf16 compute (the bf16 forms), then the Trainer's own default (fp32: the fp32 forms)
    for compute_dtype in (torch.bfloat16, None):
        extra = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
        with tempfile.TemporaryDirectory() as ckpt_dir:
            def trainer():
                return Trainer(small_params, small, epochs=10, learning_rate=1e-4,
                               num_warmup_updates=2, checkpoint_path=ckpt_dir,
                               batch_size_per_gpu=TRAIN_B * TRAIN_N, max_samples=TRAIN_B,
                               last_per_updates=2, save_per_updates=10**9, logger=None,
                               vocab_char_map=vocab, **extra)

            reset_launch_counts()
            t0 = time.perf_counter()
            first = trainer().train(dataset, resumable_with_seed=666, max_updates=2)
            t1 = time.perf_counter()
            second = trainer().train(dataset, resumable_with_seed=666, max_updates=2)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            counts = launch_counts()
            size = sum(f.stat().st_size for f in Path(ckpt_dir).iterdir()) / 2**30
        losses = first["losses"] + second["losses"]
        label = "bf16 compute" if compute_dtype else "its default dtype (fp32)"
        print(f"  Trainer (depth {TRAINER_DEPTH}, {label}): updates {first['updates']} then "
              f"resumed to {second['updates']}, losses "
              f"{[round(x, 5) for x in losses]}; {t1 - t0:.1f} s and {t2 - t1:.1f} s with the "
              f"checkpoint ({size:.2f} GiB) written, read and written again")
        if second["updates"] != 4 or len(losses) != 4 or not np.isfinite(losses).all():
            fail(f"the Trainer ({label}) did not take 2 + 2 finite updates across a resume")
        want = expected_train_launches(4, TRAINER_DEPTH, f32=compute_dtype is None)
        print(f"  kernel launches during the 4 updates: {counts} (expected {want})")
        if counts != want:
            fail(f"a training kernel did not run as often as the Trainer's steps ({label}) "
                 "require")
        for name, n in counts.items():
            train_counts[name] = train_counts.get(name, 0) + n
    del small_params
    torch.cuda.empty_cache()
    # timed before anything is profiled: once the profiler has run in a process, every
    # later launch costs the host more, and the step's wall time is the host's
    for bf16, kernels in ((True, True), (True, False), (False, True)):
        r = bench_train.run(frames=TRAIN_B * TRAIN_N, seq_len=TRAIN_N, bf16=bf16,
                            kernels=kernels)
        print(f"  bench_train {'bf16' if bf16 else 'fp32'} {'kernels' if kernels else 'plain  '}"
              f": step_ms {r['step_ms']}, train_frames_per_s {r['value']} ({r['unit']}) "
              f"[{card}]")
        torch.cuda.empty_cache()
    opt = make_optimizer()
    state = init_train_state(params, opt)
    busy = profile_once(lambda: train_step(state, batch, 5, arch, opt,
                                           compute_dtype=torch.bfloat16), profile_path,
                        f"training step, batch {TRAIN_B} x {TRAIN_N}, kernels",
                        top=25 if profile_path is not None else 6)
    print(f"  the bf16 step's device time with conv-pos convolving in bf16 under autograd: "
          f"{busy:.2f} ms; with the fp32 convolution it had before: {PARENT_TRAIN_STEP_MS} ms "
          f"(of which the convolution {PARENT_TRAIN_CONV_MS}), same protocol, H100 80GB HBM3, "
          f"700 W [{card}]")
    busy32 = profile_once(lambda: train_step(state, batch, 5, arch, opt), None if profile_path
                          is None else profile_path.with_suffix(".fp32.txt"),
                          f"fp32 training step, batch {TRAIN_B} x {TRAIN_N}, kernels",
                          top=25 if profile_path is not None else 6)
    print(f"  the fp32 step's device time: {busy32:.2f} ms [{card}]")
    del state, params
    torch.cuda.empty_cache()
    return {name: n + bwd_counts[name] + f32_bwd_counts[name]
            for name, n in train_counts.items()}


# ---------------------------------------------------------------------------
# phase 10: fine-tuning a checkpoint
# ---------------------------------------------------------------------------

LORA_FRAMES = 9_600  # the recipe's batch budget (configs/F5TTS_Base_ft_Lora.yaml)
LORA_UPDATES = 4
LORA_TIMED = 3  # further updates, each timed alone
ACC_K = 2
# allophone tokens (text/korean.py), absent from the Emilia vocab
NEW_TOKENS = ["ㄱⁱ", "ㄷⁱ", "ㅂⁱ", "ㅈⁱ", "ㄱᶜ", "ㄷᶜ", "ㅂᶜ", "ㅅʲ"]
CKPT_TEXT = "A short sentence from the converted checkpoint."


def _equal_trees(a, b) -> bool:
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    return fa.keys() == fb.keys() and all(fa[k].dtype == fb[k].dtype and bool((fa[k] == fb[k])
                                                                              .all()) for k in fa)


def phase10_checkpoint(dev, card: str, tmp: Path) -> tuple[dict[str, int], str]:
    """(a) A reference-format .pt of seeded F5TTS_v1_Base weights (torch.save,
    ema_model. prefix, q/k columns in the reference's interleaved rope layout)
    loaded by load_model: every tensor equal to the .npz route's and to the
    source, the bench-protocol mel of both routes equal; one
    F5TTS(ckpt_file=.pt).infer call. (b) A seeded Vocos state dict through
    convert_vocoder and load_vocoder(local_path=): its decode equals the
    source params' decode. Returns the launches and the .npz path."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.api import F5TTS, load_vocoder
    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer import utils_infer
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.scripts import convert_vocoder
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax, unflatten_tree
    from korean_f5_tts_tpu_torch.utils import torch_ckpt

    vocab = str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt")
    model_cfg = preset_model_config("F5TTS_v1_Base")
    t0 = time.perf_counter()
    src = load_model(model_cfg, vocab_file=vocab, seed=0, device=dev)  # seeded fp32 weights
    redraw_zero_init(src.params, seed=1)
    arch = src.arch
    flat = params_to_jax(src.params)
    sd = torch_ckpt.dit_state_dict(unflatten_tree(flat), arch.heads, arch.dim_head)
    pt, npz = tmp / "model_seeded.pt", tmp / "model_seeded.npz"
    torch.save({"ema_model_state_dict": {f"ema_model.transformer.{k}": torch.from_numpy(v)
                                         for k, v in sd.items()}, "update": 0}, str(pt))
    np.savez(npz, **{f"params/{k}": v for k, v in flat.items()})  # save_checkpoint's layout
    del flat, sd
    t1 = time.perf_counter()
    by_pt = load_model(model_cfg, ckpt_path=str(pt), vocab_file=vocab, device=dev)
    by_npz = load_model(model_cfg, ckpt_path=str(npz), vocab_file=vocab, device=dev)
    t2 = time.perf_counter()
    same = _equal_trees(by_pt.params, by_npz.params) and _equal_trees(by_pt.params, src.params)
    print(f"phase 10(a): seeded F5TTS_v1_Base ({arch.text_num_embeds} text embeds) as a "
          f"reference .pt ({pt.stat().st_size / 2**30:.2f} GiB, torch.save, ema_model. prefix) "
          f"and a .npz, written in {t1 - t0:.1f} s, both loaded in {t2 - t1:.1f} s; every tensor "
          f"of the .pt route equal to the .npz route's and to the source's: {same}")
    if not same:
        fail("load_model on a reference .pt disagrees with the .npz route")
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev), vcfg)
    inputs = tuple(x.float() if torch.is_tensor(x) and x.is_floating_point() else x
                   for x in bench_inputs(dev))
    with torch.inference_mode():
        mel_pt, _ = synthesize(by_pt, vocoder, inputs)
        mel_npz, _ = synthesize(by_npz, vocoder, inputs)
    diff = (mel_pt - mel_npz).abs().max().item()
    print(f"  bench-protocol mel (fp32 weights), .pt route vs .npz route: max abs {diff} "
          f"(bound 0), |mel| max {mel_pt.abs().max().item():.3f}")
    if diff != 0 or not torch.isfinite(mel_pt).all() or mel_pt.abs().max() == 0:
        fail("the .pt route's mel differs from the .npz route's")
    del by_pt, by_npz, src

    # one utterance through the offline entry point on the .pt
    t = np.arange(int(3.0 * SR)) / SR
    ref_path = str(tmp / "ref.wav")
    wavfile.write(ref_path, SR, (0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * t) * t)
                                 * 32767).astype(np.int16))
    quiet = {"show_info": lambda m: None}
    (ref_wav, sr), ref_text = utils_infer.preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
    ref_frames = len(ref_wav) // HOP + 1
    max_chars = int(len(ref_text.encode()) / (len(ref_wav) / sr) * (22 - len(ref_wav) / sr))
    chunks = utils_infer.chunk_text(CKPT_TEXT, max_chars=max_chars)
    if len(chunks) != 1:
        fail(f"the checkpoint's text split into {len(chunks)} chunks, expected one")
    gen_frames = int(ref_frames / (len(ref_text.encode()) + 1) * len(chunks[0].encode()))
    want_samples = (gen_frames - 1) * HOP
    tts = F5TTS(ckpt_file=str(pt), vocab_file=vocab)
    reset_launch_counts()
    t0 = time.perf_counter()
    wav, sr_out, _ = tts.infer(ref_path, REF_TEXT, CKPT_TEXT, nfe_step=STEPS, seed=3, **quiet)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_prefix_f32=STEPS * DEPTH, ff_block_f32=STEPS * DEPTH,
                grouped_conv_f32=2 * STEPS)
    rms = float(np.sqrt(np.mean(np.square(wav))))
    print(f"  F5TTS(ckpt_file=.pt).infer: {secs:.2f} s, {wav.size} samples (expected "
          f"{want_samples}) at {sr_out} Hz, rms {rms:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    if wav.size != want_samples or sr_out != SR or not np.isfinite(wav).all() or rms <= 0:
        fail("F5TTS(ckpt_file=.pt): wrong length, rate or silent audio")
    if counts != want:
        fail(f"F5TTS(ckpt_file=.pt): expected launches {want}")
    del tts

    # (b) a Vocos state dict through convert_vocoder and load_vocoder(local_path=)
    voc_sd = torch_ckpt.vocos_state_dict(unflatten_tree(params_to_jax(vocoder.params)))
    torch.save({k: torch.from_numpy(v) for k, v in voc_sd.items()}, str(tmp / "vocos.bin"))
    convert_vocoder.convert(str(tmp / "vocos.bin"), str(tmp / "vocos.npz"))
    loaded = load_vocoder(is_local=True, local_path=str(tmp / "vocos.npz"), device=dev)
    mel = torch.randn((1, 100, 400), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    got, want_wav = loaded(mel), vocoder(mel)
    vdiff = (got - want_wav).abs().max().item()
    print(f"phase 10(b): Vocos .bin -> convert_vocoder -> load_vocoder(local_path=): weights "
          f"equal {_equal_trees(loaded.params, vocoder.params)}, decode of a [1, 100, 400] mel "
          f"max abs {vdiff} against the source params' (bound 0)")
    if vdiff != 0 or not _equal_trees(loaded.params, vocoder.params):
        fail("the converted vocoder differs from its source")
    return counts, str(npz)


def phase10_lora(dev, card: str, tmp: Path, pretrained: str):
    """(c) vocab_extend with 8 new tokens on the .npz of (a), then train_lora's
    loop on the F5TTS_Base recipe arch in fp32 over seeded mels at the
    recipe's 9,600-frame budget. Returns (launches, a closure that profiles
    one more update)."""
    import dataclasses

    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.data.dataset import CustomDataset, collate_batch
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.lora import DEFAULT_TARGETS, init_lora
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.text.vocab import load_vocab_file
    from korean_f5_tts_tpu_torch.train import train_lora, vocab_extend
    from korean_f5_tts_tpu_torch.train.checkpoint import (
        flatten_tree,
        load_npz_params,
        params_to_jax,
    )
    from korean_f5_tts_tpu_torch.train.step import PlainAdamW
    from korean_f5_tts_tpu_torch.utils.misc import fold_in

    t0 = time.perf_counter()
    extended, new_vocab = tmp / "extended.npz", tmp / "vocab_extended.txt"
    n_vocab = vocab_extend.extend_checkpoint(pretrained, str(extended),
                                             str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"),
                                             NEW_TOKENS, str(new_vocab))
    model_cfg = preset_model_config("F5TTS_Base")
    arch = dataclasses.replace(model_cfg.arch, text_num_embeds=n_vocab + 1)  # as train_lora
    base = train_lora.load_base_params(str(extended), arch, dev)
    from_file = load_npz_params(str(extended))
    flat = flatten_tree(base)
    kept = sorted(k for k, v in params_to_jax(base).items() if from_file[k].shape != v.shape)
    print(f"phase 10(c): vocab_extend: {n_vocab} tokens (+{len(NEW_TOKENS)}), "
          f"text_embed rows {from_file['text_embed/embed/w'].shape[0]} in the file; the "
          f"F5TTS_Base recipe arch for {n_vocab} tokens has {flat['text_embed/embed/w'].shape[0]}"
          f" (text_num_embeds = vocab + 1, one filler row): leaves kept at their seeded init by "
          f"the shape-mismatch skip: {kept}; {time.perf_counter() - t0:.1f} s")
    del from_file
    adapters = init_lora(base, DEFAULT_TARGETS, seed=0)
    optimizer = PlainAdamW(learning_rate=1e-5)  # the recipe's optim.learning_rate
    opt_state = optimizer.init(train_lora.trainable_leaves(base, adapters))
    frozen = {k: v.clone() for k, v in flat.items()}
    start = {f"{p}/{k}": v.clone() for p, ad in adapters.items() for k, v in ad.items()}

    vocab_map = load_vocab_file(str(new_vocab))
    letters = [t for t in vocab_map if len(t) == 1 and t.isascii() and t.isalpha()]
    rng = np.random.default_rng(8)
    rows = []
    for _ in range(LORA_UPDATES * 8):
        f = int(rng.integers(1000, 1200))
        text = [str(x) for x in rng.choice(letters + NEW_TOKENS + [" "], 120)]  # tokens
        rows.append({"mel_spec": rng.standard_normal((100, f)).astype(np.float32),
                     "text": text, "duration": f * HOP / SR})
    dataset = CustomDataset(rows, preprocessed_mel=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = train_lora.train_loop(base, adapters, optimizer, opt_state, dataset, arch, vocab_map,
                                str(tmp / "lora"), batch_size_per_gpu=LORA_FRAMES, epochs=1,
                                max_updates=LORA_UPDATES, save_every=10**9)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flash_prefix_lse_f32": arch.depth * LORA_UPDATES,
                 "flash_prefix_dq_lsein_f32": arch.depth * LORA_UPDATES,
                 "flash_prefix_dkv_f32": arch.depth * LORA_UPDATES})
    batch_np = collate_batch([dataset[i] for i in range(8)], vocab_map)
    print(f"  train_lora loop: {res['updates']} updates at a {LORA_FRAMES}-frame budget (8 rows "
          f"of 1000-1200 frames, padded to {batch_np['mel'].shape[1]}), fp32, "
          f"checkpoint_activations {arch.checkpoint_activations}, pe_attn_head "
          f"{arch.pe_attn_head}: losses {[round(x, 5) for x in res['losses']]}; {secs:.1f} s "
          f"with the merged .npz written; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    print(f"  launches: { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }, every other counter 0)")
    if res["updates"] != LORA_UPDATES or not np.isfinite(res["losses"]).all():
        fail("the LoRA loop did not take 4 finite updates")
    if counts != want:
        fail("the LoRA update did not run the fp32 forms of 10, 11, 13 once per block")
    same_base = all(torch.equal(v, frozen[k]) for k, v in flatten_tree(base).items())
    moved = {leaf: sum(not torch.equal(ad[leaf], start[f"{p}/{leaf}"])
                       for p, ad in adapters.items()) for leaf in ("a", "b", "scale")}
    print(f"  base tensors bit-identical after training: {same_base}; adapters moved (of "
          f"{len(adapters)}): {moved}")
    if not same_base or min(moved.values()) < len(adapters):
        fail("LoRA training changed a base tensor or left an adapter leaf unmoved")
    del frozen

    batch = {k: torch.from_numpy(batch_np[src]).to(dev)
             for k, src in (("mel", "mel"), ("text", "text"), ("lens", "mel_lengths"))}
    times = []
    for i in range(LORA_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_lora.lora_train_step(base, adapters, opt_state, batch, fold_in(7, i), arch,
                                   optimizer)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"  ms per LoRA update (batch {tuple(batch['mel'].shape[:2])}, each timed alone): "
          f"{', '.join(f'{x:.1f}' for x in times)} [{card}]")

    # the merged checkpoint reloads through load_model and samples one utterance
    merged = load_model(model_cfg, ckpt_path=res["path"], vocab_file=str(new_vocab),
                        device=dev)
    if merged.arch.text_num_embeds != arch.text_num_embeds:
        fail("the merged checkpoint's vocab does not load back")
    moved_w = not torch.equal(merged.params["blocks"][0]["attn"]["to_q"]["w"],
                              base["blocks"][0]["attn"]["to_q"]["w"])
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos

    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev), vcfg)
    inputs = tuple(x.float() if torch.is_tensor(x) and x.is_floating_point() else x
                   for x in bench_inputs(dev))
    with torch.inference_mode():
        mel, wav = synthesize(merged, vocoder, inputs)
    ok = bool(torch.isfinite(mel).all() and torch.isfinite(wav).all()) and mel.abs().max() > 0
    print(f"  merged .npz through load_model (F5TTS_Base, {n_vocab}-token vocab): the adapted "
          f"projections differ from the base: {moved_w}; one bench-protocol utterance: mel "
          f"{tuple(mel.shape)}, wav {tuple(wav.shape)}, finite and not silent: {ok}")
    if not (moved_w and ok):
        fail("the merged LoRA checkpoint does not sample")
    del merged, vocoder

    def profile() -> None:
        busy = profile_once(lambda: train_lora.lora_train_step(
            base, adapters, opt_state, batch, 11, arch, optimizer), None,
            f"LoRA update, F5TTS_Base fp32, batch {tuple(batch['mel'].shape[:2])}", top=6)
        print(f"phase 10(c): a LoRA update's device busy time {busy:.2f} ms [{card}]")

    return counts, profile


def phase10_accumulation(dev, card: str, tmp: Path) -> dict[str, int]:
    """(d) Trainer(grad_accumulation_steps=2) at depth 4, as phase 6's
    Trainer runs (fp32, full remat). The uninterrupted run is Trainer.train's
    loop written out (its optimizer, state, batches in epoch order and seeds
    fold_in(666, update)), so each mini-step can be looked at: the weights
    move at mini-steps 2 and 4 only. A Trainer run of 3 mini-steps resumed
    for 1 more ends within rel 1e-6 of it, with 2 optimizer updates."""
    import dataclasses

    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.data.dataset import CustomDataset
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree
    from korean_f5_tts_tpu_torch.train.step import train_step
    from korean_f5_tts_tpu_torch.train.trainer import Trainer
    from korean_f5_tts_tpu_torch.utils.misc import fold_in

    small = dataclasses.replace(train_arch(), depth=TRAINER_DEPTH)
    params = redraw_zero_init(init_dit(small, seed=0, device=dev), seed=1)
    rng = np.random.default_rng(4)
    frames = [int(f) for f in rng.integers(TRAIN_N - 120, TRAIN_N + 1, 2 * TRAIN_B)]
    rows = [{"mel_spec": rng.standard_normal((100, f)).astype(np.float32),
             "text": "this is a training row", "duration": f * HOP / SR} for f in frames]
    dataset = CustomDataset(rows, preprocessed_mel=True)
    vocab = {c: i + 1 for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz")}

    def trainer(name):
        return Trainer(params, small, epochs=10, learning_rate=1e-4, num_warmup_updates=2,
                       checkpoint_path=str(tmp / name), batch_size_per_gpu=TRAIN_B * TRAIN_N,
                       max_samples=TRAIN_B, last_per_updates=10**9, save_per_updates=10**9,
                       logger=None, vocab_char_map=vocab, grad_accumulation_steps=ACC_K)

    reset_launch_counts()
    t0 = time.perf_counter()
    whole = trainer("whole")
    sampler = whole._make_batches(dataset, 666)
    order = []
    for epoch in range(2):  # 2 batches an epoch
        sampler.set_epoch(epoch)
        order += list(sampler)
    moved = []
    for i, idx in enumerate(order[:4]):
        before = [v.clone() for v in flatten_tree(whole.state.params).values()]
        whole.state, _ = train_step(whole.state, whole._place_batch(*whole._load_local_batch(
            dataset, idx)), fold_in(666, i), small, whole.optimizer)
        moved.append(any(not torch.equal(a, b) for a, b in
                         zip(before, flatten_tree(whole.state.params).values())))
    opt = whole.state.opt_state
    print(f"phase 10(d): Trainer(grad_accumulation_steps={ACC_K}) at depth {TRAINER_DEPTH}, "
          f"its step over its batches: weights moved after mini-steps 1-4: {moved} (expected "
          f"[False, True, False, True]); gradient_step {opt['gradient_step']}, schedule count "
          f"{opt['inner']['sched_count']}, adam count {opt['inner']['count']}, mini_step "
          f"{opt['mini_step']}")
    if moved != [False, True, False, True] or opt["gradient_step"] != 2 \
            or opt["inner"]["sched_count"] != 2 or opt["mini_step"] != 0:
        fail("gradient accumulation did not update on every second mini-step")
    first = trainer("resumed").train(dataset, resumable_with_seed=666, max_updates=3)
    resumed = trainer("resumed")
    res = resumed.train(dataset, resumable_with_seed=666, max_updates=1)
    torch.cuda.synchronize()
    counts = launch_counts()
    a = torch.cat([v.flatten() for v in flatten_tree(resumed.state.params).values()])
    b = torch.cat([v.flatten() for v in flatten_tree(whole.state.params).values()])
    err = _rel(a, b)
    state = resumed.state.opt_state
    print(f"  Trainer.train: 3 mini-steps (losses {[round(x, 5) for x in first['losses']]}), "
          f"checkpoint, resume, 1 more (update {res['updates']}): params rel L2 {err:.3e} "
          f"against the uninterrupted run (bound 1e-6); gradient_step "
          f"{state['gradient_step']}, schedule count {state['inner']['sched_count']}; "
          f"{time.perf_counter() - t0:.1f} s with 2 checkpoints written and 1 read [{card}]")
    if err > 1e-6 or res["updates"] != 4 or state["gradient_step"] != 2 \
            or state["inner"]["sched_count"] != 2:
        fail("a resumed accumulation run does not end where the uninterrupted one does")
    want = expected_train_launches(8, TRAINER_DEPTH, f32=True)
    print(f"  launches of the 8 mini-steps: { {k: v for k, v in counts.items() if v} }")
    if counts != want:
        fail(f"the accumulation runs: expected launches {want}")
    return counts


def phase10_finetune(dev, card: str):
    """Phase 10: returns (launches, the deferred profile of a LoRA update)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        total, npz = phase10_checkpoint(dev, card, Path(tmp))
        torch.cuda.empty_cache()
        counts, profile = phase10_lora(dev, card, Path(tmp), npz)
        total = {k: total[k] + counts[k] for k in total}
        torch.cuda.empty_cache()
        counts = phase10_accumulation(dev, card, Path(tmp))
        total = {k: total[k] + counts[k] for k in total}
    torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t0:.1f} s [{card}]")
    return total, profile


# ---------------------------------------------------------------------------
# phase 11: the UNetT and MMDiT backbones, qk-norm, the Small presets, BigVGAN
# ---------------------------------------------------------------------------

VOCAB = "data/Emilia_ZH_EN_pinyin/vocab.txt"
E2_DEPTH = 24
BACKBONE_TRAIN_DEPTH = 8  # the training steps and the checkpoint file of phase 11 (c, d, b)


def launches_of(**counts) -> dict[str, int]:
    from korean_f5_tts_tpu_torch.ops import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    return want


def sample_and_hold(label: str, model, vocoder, want: dict[str, int], *,
                    attn_path: str = "default", card: str = "", rtf: bool = False,
                    attn_int8: str | None = None) -> None:
    """One bench-protocol utterance (cond 432, total 1376, bucket 1536, 160
    text tokens, CFG 2, sway -1, EPSS, 16 steps) with kernels, its exact
    launch counts, its mel against the plain versions' (relative L2 over the
    valid rows, bound 5e-2, the bf16 sampler's bound of phases 4 and 9);
    attn_int8 as the sampler's; with rtf, the RTF over 5 timed runs and one utterance's device time."""
    import torch

    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts

    inputs = bench_inputs(model.device)
    total = 1376
    synthesize(model, vocoder, inputs, attn_path=attn_path, attn_int8=attn_int8)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    mel_k, wav_k = synthesize(model, vocoder, inputs, attn_path=attn_path, attn_int8=attn_int8)
    torch.cuda.synchronize()
    counts = launch_counts()
    mel_p, _ = synthesize(model, vocoder, inputs, kernels=False, attn_path=attn_path,
                          attn_int8=attn_int8)
    a, b = mel_k[:, :total].float(), mel_p[:, :total].float()
    err = ((a - b).norm() / b.norm()).item()
    print(f"  {label}: mel rel err, kernels vs plain {err:.3e} (bound 5e-2), mean |mel| "
          f"{a.abs().mean().item():.3f}; launches {({k: v for k, v in counts.items() if v})}")
    if not (torch.isfinite(mel_k).all() and torch.isfinite(wav_k).all()) or a.abs().max() == 0:
        fail(f"{label}: non-finite or zero mel")
    if err > 5e-2:
        fail(f"{label}: the sampler with kernels disagrees with the plain versions")
    if counts != want:
        fail(f"{label}: launches {counts}, expected {({k: v for k, v in want.items() if v})}")
    if rtf:
        gen_seconds = inputs[5] * HOP / SR
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            synthesize(model, vocoder, inputs, attn_path=attn_path, attn_int8=attn_int8)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        synthesize(model, vocoder, inputs, attn_path=attn_path, attn_int8=attn_int8)
        end.record()
        torch.cuda.synchronize()
        mean = sum(times) / len(times)
        print(f"  {label}: {mean * 1e3:.2f} ms per utterance (min {min(times) * 1e3:.2f}), RTF "
              f"{mean / gen_seconds:.5f}; one utterance {start.elapsed_time(end):.2f} ms between "
              f"CUDA events on the device's stream [{card}]")


def backbone_train_step(label: str, dev, arch, params, batch, card: str) -> dict[str, int]:
    """One training step's loss and whole gradient with kernels against the
    plain versions, in fp32 (train_step's default) and in bf16 compute, the
    same draws on both sides (dropout off); the kernels' step then applies
    its update (loss_and_grads + apply_updates, which is train_step). Exact
    launches: per block kernel 10, 11 and 13 once (no remat), in the form of
    the compute dtype; conv-pos is plain tensor code under autograd."""
    import torch

    from korean_f5_tts_tpu_torch.models.cfm import draw_cfm
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.train.step import (
        AdamW,
        apply_updates,
        init_train_state,
        loss_and_grads,
    )

    total = dict.fromkeys(launch_counts(), 0)
    for dtype, bound_ in ((None, F32_GRAD_REL), (torch.bfloat16, TRAIN_REL)):
        gen = torch.Generator(device=dev).manual_seed(5)
        draws = draw_cfm(tuple(batch["mel"].shape), batch["lens"], gen,
                         dtype=dtype or torch.float32)
        reset_launch_counts()
        t0 = time.perf_counter()
        loss_k, grads_k = loss_and_grads(params, batch, 0, arch, compute_dtype=dtype, draws=draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        loss_p, grads_p = loss_and_grads(params, batch, 0, arch, compute_dtype=dtype,
                                         kernels=False, draws=draws)
        gk = torch.cat([g.flatten().float() for g in grads_k])
        gp = torch.cat([g.flatten().float() for g in grads_p])
        grel = ((gk - gp).norm() / gp.norm()).item()
        lrel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        tag = "fp32" if dtype is None else "bf16"
        print(f"  {label} {tag} step at {TRAIN_B} x {TRAIN_N} frames: loss {loss_k.item():.5f} "
              f"(plain {loss_p.item():.5f}, rel {lrel:.2e}), gradient rel L2 {grel:.3e} (bound "
              f"{bound_:.0e}), {secs:.2f} s for the step's loss and gradients [{card}]")
        if not torch.isfinite(gk).all() or grel > bound_ or lrel > bound_:
            fail(f"{label} {tag}: the training step with kernels disagrees with the plain one")
        f = "_f32" if dtype is None else ""
        want = launches_of(**{f"flash_prefix_lse{f}": arch.depth,
                              f"flash_prefix_dq_lsein{f}": arch.depth,
                              f"flash_prefix_dkv{f}": arch.depth})
        print(f"    launches {({k: v for k, v in counts.items() if v})}")
        if counts != want:
            fail(f"{label} {tag}: launches {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        if dtype is None:  # train_step = loss_and_grads + apply_updates
            opt = AdamW()
            state = apply_updates(init_train_state(params, opt, use_ema=False), grads_k, opt)
            print(f"    the update applied: step {state.step}")
        del grads_k, grads_p, gk, gp
        torch.cuda.empty_cache()
    return total


def phase11_backbones(dev, card: str, tmp: Path) -> dict[str, int]:
    """Phase 11 (a)-(g); returns the launches of its kernel runs."""
    import dataclasses

    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.api import F5TTS
    from korean_f5_tts_tpu_torch.config import MMDiTConfig, ModelConfig, preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.bigvgan import BigVGANConfig, bigvgan_decode, init_bigvgan
    from korean_f5_tts_tpu_torch.models.dit import count_params, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.mmdit import init_mmdit
    from korean_f5_tts_tpu_torch.models.unett import init_unett
    from korean_f5_tts_tpu_torch.ops import KERNELS
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, params_to_jax, unflatten_tree
    from korean_f5_tts_tpu_torch.utils import torch_ckpt

    t_start = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def f5tts(name, **kw):
        tts = F5TTS(model=name, vocab_file=str(ROOT / VOCAB), compute_dtype=torch.bfloat16,
                    device="cuda", seed=0, **kw)
        redraw_zero_init(tts.ema_model.params, seed=1)
        arch = tts.ema_model.arch
        print(f"  {name}: {type(arch).__name__} dim {arch.dim} depth {arch.depth} heads "
              f"{arch.heads}x{arch.dim_head} ff_mult {arch.ff_mult}: "
              f"{count_params(tts.ema_model.params) / 1e6:.1f} M params, bf16")
        return tts

    # (a) E2TTS_Base through the offline entry point's model, sampled and served
    print("phase 11(a): E2TTS_Base (UNetT) through F5TTS(model='E2TTS_Base'), bf16")
    tts = f5tts("E2TTS_Base")
    want = launches_of(flash_prefix=E2_DEPTH * STEPS, grouped_conv=2 * STEPS)
    sample_and_hold("E2TTS_Base", tts.ema_model, tts.vocoder, want, card=card, rtf=True)
    add(want)
    add(phase3_serve(tts.ema_model, tts.vocoder, "bf16", want_per_batch=want, phase=11))
    del tts
    torch.cuda.empty_cache()

    # (b) a reference-format UNetT checkpoint through load_model
    arch = dataclasses.replace(preset_model_config("E2TTS_Base").arch, depth=BACKBONE_TRAIN_DEPTH,
                               text_num_embeds=2545)
    flat = params_to_jax(init_unett(arch, seed=3, device=dev))
    sd = torch_ckpt.unett_state_dict(unflatten_tree(flat), arch.heads, arch.dim_head)
    t0 = time.perf_counter()
    pt, npz = tmp / "e2.pt", tmp / "e2.npz"
    torch.save({"ema_model_state_dict": {f"ema_model.transformer.{k}": torch.from_numpy(v)
                                         for k, v in sd.items()}}, str(pt))
    np.savez(npz, **{f"ema_params/{k}": v for k, v in flat.items()})
    mcfg = ModelConfig(name="E2TTS_Base", backbone="UNetT", arch=arch)
    a = flatten_tree(load_model(mcfg, ckpt_path=str(pt), device=dev).params)
    b = flatten_tree(load_model(mcfg, ckpt_path=str(npz), device=dev).params)
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(f"phase 11(b): a UNetT (E2TTS_Base widths, depth {BACKBONE_TRAIN_DEPTH}) as a "
          f"reference-format .pt ({pt.stat().st_size / 1e6:.0f} MB) and as an .npz, both through "
          f"load_model(ckpt_path=): {len(a)} tensors {'equal to the bit' if same else 'DIFFER'} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        fail("the reference-format UNetT checkpoint loads another tree than the .npz")
    del a, b, sd, flat
    torch.cuda.empty_cache()

    # (c) UNetT training steps
    print(f"phase 11(c): UNetT training step (E2TTS_Base widths, depth {BACKBONE_TRAIN_DEPTH}, "
          "no remat, as the E2TTS configs set)")
    params = init_unett(arch, seed=4, device=dev)
    batch = train_batch(dev)
    add(backbone_train_step("UNetT", dev, arch, params, batch, card))
    del params
    torch.cuda.empty_cache()

    # (d) MMDiT at MMDiTConfig()'s own widths
    print("phase 11(d): MMDiT at MMDiTConfig()'s widths, bf16 sampling and an fp32/bf16 step")
    march = MMDiTConfig(text_num_embeds=2545)
    model = load_model(ModelConfig(name="MMDiT", backbone="MMDiT", arch=march),
                       dtype=torch.bfloat16, seed=0, device=dev)
    redraw_zero_init(model.params, seed=1)
    print(f"  MMDiT dim {march.dim} depth {march.depth} heads {march.heads}x{march.dim_head} "
          f"ff_mult {march.ff_mult}: {count_params(model.params) / 1e6:.1f} M params")
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    want = launches_of(flash_prefix=march.depth * STEPS, grouped_conv=2 * STEPS)
    sample_and_hold("MMDiT", model, vocoder, want, card=card, rtf=True)
    add(want)
    del model
    torch.cuda.empty_cache()
    tarch = dataclasses.replace(march, depth=BACKBONE_TRAIN_DEPTH)
    params = redraw_zero_init(init_mmdit(tarch, seed=4, device=dev), seed=5)
    add(backbone_train_step("MMDiT", dev, tarch, params, batch, card))
    del params, batch
    torch.cuda.empty_cache()

    # (e) a qk-norm DiT: the default path, linear_fused, int8 weights
    print("phase 11(e): F5TTS_v1_Base with qk_norm='rms_norm' (5, 6, 7, 8 must not run)")
    qk = preset_model_config("F5TTS_v1_Base", arch={"qk_norm": "rms_norm"})
    per = DEPTH * STEPS
    for quantize in (False, True):
        model = load_model(qk, vocab_file=str(ROOT / VOCAB), dtype=torch.bfloat16, seed=0,
                           device=dev, quantize=quantize)
        redraw_zero_init(model.params, seed=1)
        if quantize:
            want = launches_of(flash_prefix=per, ff_block_int8=per, qmatmul=4 * per,
                               grouped_conv=2 * STEPS)
            sample_and_hold("qk-norm DiT, int8 weights", model, vocoder, want)
            add(want)
        else:
            want = launches_of(flash_prefix=per, ff_block=per, grouped_conv=2 * STEPS)
            for path in ("default", "linear_fused"):
                sample_and_hold(f"qk-norm DiT, bf16, attn_path {path}", model, vocoder, want,
                                attn_path=path)
                add(want)
        del model
        torch.cuda.empty_cache()

    # (f) the Small presets: conv-pos at 48 channels a group takes no kernel
    print("phase 11(f): F5TTS_Small and E2TTS_Small (dim 768: 48 channels a conv-pos group)")
    for name, depth, extra in (("F5TTS_Small", 18, "ff_block"), ("E2TTS_Small", 20, None)):
        tts = f5tts(name)
        want = launches_of(flash_prefix=depth * STEPS,
                           **({extra: depth * STEPS} if extra else {}))
        sample_and_hold(name, tts.ema_model, tts.vocoder, want, card=card, rtf=True)
        add(want)
        del tts
        torch.cuda.empty_cache()

    # (g) BigVGAN
    print("phase 11(g): BigVGAN (bigvgan_v2 24 kHz 100-band 256x config), plain PyTorch")
    bcfg = BigVGANConfig()
    bp = init_bigvgan(bcfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    mel = torch.randn((1, 100, 1376), generator=gen, device=dev)
    with torch.inference_mode():
        bigvgan_decode(bp, mel[:, :, :64], bcfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = bigvgan_decode(bp, mel, bcfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        short = mel[:, :, :24]
        on_card = bigvgan_decode(bp, short, bcfg)
        cpu = bigvgan_decode(_to_device(bp, "cpu"), short.cpu(), bcfg)
    err = _rel(on_card.cpu(), cpu)
    print(f"  {count_params(bp) / 1e6:.1f} M params; a 1376-frame mel -> {wav.shape[-1]} samples "
          f"(expected {1376 * 256}) in {ms:.1f} ms, fp32, finite {bool(torch.isfinite(wav).all())}"
          f"; a 24-frame mel on the card against the CPU, fp32, TF32 off: rel {err:.3e} (bound "
          f"1e-4) [{card}]")
    if wav.shape != (1, 1376 * 256) or not torch.isfinite(wav).all() or err > 1e-4:
        fail("BigVGAN: wrong length, non-finite samples or a card/CPU mismatch")
    del bp, wav
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_start:.1f} s [{card}]")
    return total


def check_tp_shards(gen, dev) -> None:
    """Kernels A, B, 4, 5, 6, 7, 8, 10, 11, 13 and 14 (with its pass) at the
    shapes a tensor-parallel rank gives them, tp 2 and tp 4 of F5TTS_v1_Base
    (16 heads x 64, inner 1024, FF 2048): 16 / tp heads, q | k | v columns
    3 x 1024 / tp, FF 2048 / tp, out-projection inputs 1024 / tp; against
    their plain versions at the bounds of their main-shape checks."""
    import torch

    from korean_f5_tts_tpu_torch.ops import ff_block as fb
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    bf = torch.bfloat16
    print("tensor-parallel shard shapes (tp 2, tp 4): each kernel against its plain version")
    for tp in (2, 4):
        heads, inner, ff = 16 // tp, 1024 // tp, 2048 // tp
        q, k, v = (torch.randn((2 * heads, 1536, 64), generator=gen, device=dev).to(bf)
                   for _ in range(3))
        kv = torch.full((2 * heads,), 1376, dtype=torch.int32, device=dev)
        compare(f"tp {tp}: kernel A H={2 * heads} n=1536", fp.flash_prefix_folded(q, k, v, kv),
                fp.prefix_attention_reference(q, k, v, kv), 1e-2)
        q4, k4, v4 = (t.reshape(2, heads, 1536, 64) for t in (q, k, v))
        lens = torch.full((2,), 1376, dtype=torch.int32, device=dev)
        for mode, rel in (("qkpv", 2e-3), ("qk", 5e-3)):
            pv = mode == "qkpv"
            compare(f"tp {tp}: kernel 14 {mode} + its pass, {heads} heads",
                    fp.flash_prefix_attention_i8(q4, k4, v4, lens, pv_i8=pv),
                    fp.flash_prefix_attention_i8(q4, k4, v4, lens, pv_i8=pv, kernels=False), rel)
        h = torch.randn((2, 1536, 1024), generator=gen, device=dev).to(bf)
        sc, sh, gate = _uni(gen, dev, (1024,), 0.3), _uni(gen, dev, (1024,), 0.3), \
            _uni(gen, dev, (1024,), 1.0)
        w1, b1 = _uni(gen, dev, (ff, 1024), 1024 ** -0.5), _uni(gen, dev, (ff,), 1024 ** -0.5)
        w2, b2 = _uni(gen, dev, (1024, ff), ff ** -0.5), _uni(gen, dev, (1024,), ff ** -0.5)
        args = (h, sc, sh, gate, w1, b1, w2, b2)
        compare(f"tp {tp}: kernel B dff={ff}", fb.ff_block_fused(*args),
                fb.ff_block_reference(*args), 5e-3)
        qin, qout = _int8_linear(gen, dev, ff, 1024), _int8_linear(gen, dev, 1024, ff)
        compare(f"tp {tp}: kernel 4 dff={ff}", fb.ff_block_fused_int8(h, sc, sh, gate, qin, qout),
                fb.ff_block_int8_reference(h, sc, sh, gate, qin, qout), INT8_REL)
        qkv8 = [_int8_linear(gen, dev, inner, 1024) for _ in range(3)]
        compare(f"tp {tp}: kernel 5 n=3x{inner}", fl.ln_mod_matmul_int8(h, sc, sh, qkv8),
                fl.ln_mod_matmul_int8_reference(h, sc, sh, qkv8), INT8_REL)
        a = torch.randn((2, 1536, inner), generator=gen, device=dev).to(bf)
        out8 = _int8_linear(gen, dev, 1024, inner)
        compare(f"tp {tp}: kernel 6 din={inner}", fl.proj_gated_residual_int8(a, h, gate, out8),
                fl.proj_gated_residual_int8_reference(a, h, gate, out8), INT8_REL)
        ps = [_linear(gen, dev, inner, 1024) for _ in range(3)]
        compare(f"tp {tp}: kernel 7 n=3x{inner}", fl.ln_mod_matmul(h, sc, sh, ps),
                fl.ln_mod_matmul_reference(h, sc, sh, ps), 5e-3)
        po = _linear(gen, dev, 1024, inner)
        compare(f"tp {tp}: kernel 8 din={inner}", fl.proj_gated_residual(a, h, gate, po),
                fl.proj_gated_residual_reference(a, h, gate, po), 5e-3)
        H = TRAIN_B * heads
        q, k, v, do = (torch.randn((H, TRAIN_N, 64), generator=gen, device=dev).to(bf)
                       for _ in range(4))
        kv = torch.randint(TRAIN_N * 3 // 4, TRAIN_N + 1, (H,), generator=gen, device=dev,
                           dtype=torch.int32)
        o10, lse10 = fp.flash_prefix_folded_lse(q, k, v, kv)
        o, lse = fp.prefix_attention_lse_reference(q, k, v, kv)
        compare(f"tp {tp}: kernel 10 o H={H} n={TRAIN_N}", o10, o, 1e-2)
        compare(f"tp {tp}: kernel 10 lse", lse10, lse, 1e-5)
        dvec = (do.float() * o.float()).sum(dim=-1)
        compare(f"tp {tp}: kernel 11 dq", fp.flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv),
                fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv), 1e-2)
        dk, dv = fp.flash_prefix_dkv(q, k, v, do, dvec, lse, kv)
        dk_p, dv_p = fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv)
        compare(f"tp {tp}: kernel 13 dk", dk, dk_p, 1e-2)
        compare(f"tp {tp}: kernel 13 dv", dv, dv_p, 1e-2)
        del o, lse, o10, lse10, dk, dv, dk_p, dv_p
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the rest of training (kernels 7, 8, 18, 19 under autograd, "dots")
# and parallelism (tensor-parallel serving, data- and tensor-parallel training,
# a sharded checkpoint, NCCL at world size 1)
# ---------------------------------------------------------------------------

P12_DEPTH = 8  # phase 12's training steps and sharded checkpoint (full width, 8 blocks)
P12_TIMEOUT = 600  # seconds the two ranks of phase 12 may take together


def _gathered(grads, paths, mesh):
    """The whole gradient (flatten_tree order) from a rank's share."""
    from korean_f5_tts_tpu_torch.parallel.mesh import unshard_params
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree

    return list(flatten_tree(unshard_params(unflatten_tree(dict(zip(paths, grads))),
                                            mesh)).values())


def phase12_worker(rank: int) -> None:
    """One of phase 12's two ranks on the one card: gloo over CUDA tensors
    (NCCL refuses two ranks on one device), a 1 x 2 or 2 x 1 mesh. Rank 0
    also computes the one-process references and holds the ranks to them."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from korean_f5_tts_tpu_torch.config import MMDiTConfig, ModelConfig, preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.mmdit import init_mmdit
    from korean_f5_tts_tpu_torch.models.unett import init_unett
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from korean_f5_tts_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
    from korean_f5_tts_tpu_torch.train import checkpoint as ckpt
    from korean_f5_tts_tpu_torch.train.step import AdamW, init_train_state, loss_and_grads

    os.environ["F5_TTS_DIST_PROCESS_ID"] = str(rank)
    if not maybe_initialize_distributed("cuda", backend="gloo"):
        fail("phase 12: the two ranks did not form a process group")
    dev = torch.device("cuda", torch.cuda.current_device())
    tag = f"[rank {rank}]"

    def both_equal(x, label):  # rank 1's tensor is rank 0's, to the bit
        ref = x.detach().clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, x):
            fail(f"{label}: the ranks disagree")

    # (a) tensor-parallel serving, the bench protocol
    tp_mesh = make_mesh(1, 2, device="cuda")
    total = 1376
    for mode in ("bf16", "int8"):
        model, vocoder = build_model(dev, quantize=mode == "int8")
        local = shard_params(model.params, tp_mesh)
        inputs = bench_inputs(dev)
        for attn_path in ("default", "linear_fused") if mode == "bf16" else ("default",):
            reset_launch_counts()
            t0 = time.perf_counter()
            mel, wav = synthesize(model, vocoder, inputs, params=local, attn_path=attn_path,
                                  mesh=tp_mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            # one utterance of batch 1: expected_launches' own batch of 2 (kernel 9) left out
            want = {**expected_launches(mode, 1, attn_path), "qmatmul": 0}
            print(f"  {tag} (a) {mode} {attn_path}: launches {({k: v for k, v in counts.items() if v})}")
            if counts != want:
                fail(f"phase 12 (a) {mode} {attn_path}: launches {counts}, expected {want}")
            if not (torch.isfinite(mel).all() and torch.isfinite(wav).all()):
                fail(f"phase 12 (a) {mode} {attn_path}: non-finite mel or waveform")
            both_equal(mel, f"phase 12 (a) {mode} {attn_path} mel")
            if rank == 0:
                one, _ = synthesize(model, vocoder, inputs, attn_path=attn_path)
                a, b = mel[:, :total].float(), one[:, :total].float()
                rel = ((a - b).norm() / b.norm()).item()
                print(f"  (a) tp 2 {mode} {attn_path}: mel rel L2 {rel:.3e} to one process "
                      f"(bound 5e-2); {ms:.1f} ms an utterance with both ranks on one card "
                      "(gloo through the host; a correctness run, no tensor-parallel speed)")
                if rel > 5e-2:
                    fail(f"phase 12 (a) {mode} {attn_path}: tp 2 disagrees with one process")
        del model, vocoder, local
        torch.cuda.empty_cache()

    # (b) one training step at 8 x 1280, data parallel and tensor parallel
    import dataclasses

    meshes = {"dp 2": make_mesh(2, 1, device="cuda"), "tp 2": tp_mesh}

    def sharded_steps(label: str, arch, params, want_of) -> None:
        """One step's loss and whole gradient on each mesh against one
        process (rank 0 computes it), bf16 and fp32; each rank's launches
        want_of(f32)."""
        paths = list(ckpt.flatten_tree(params))
        batch = train_batch(dev)
        for dtype, bound_ in ((torch.bfloat16, TRAIN_REL), (None, F32_GRAD_REL)):
            dname = "bf16" if dtype else "fp32"
            one = None
            if rank == 0:
                loss1, g1 = loss_and_grads(params, batch, 5, arch, compute_dtype=dtype)
                one = (loss1.item(), torch.cat([g.flatten().float() for g in g1]))
                del g1
            for name, mesh in meshes.items():
                local = shard_params(params, mesh)
                rows = shard_batch(batch, mesh)
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                loss, grads = loss_and_grads(local, rows, 5, arch, compute_dtype=dtype, mesh=mesh)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
                want = want_of(dtype is None)
                print(f"  {tag} {label} {name} {dname}: rows {rows['mel'].shape[0]}, launches "
                      f"{({k: v for k, v in counts.items() if v})}, {secs:.2f} s, peak "
                      f"{peak:.2f} GiB")
                if counts != want:
                    fail(f"phase 12 {label} {name} {dname}: launches {counts}, expected {want}")
                whole = torch.cat([g.flatten().float() for g in _gathered(grads, paths, mesh)])
                both_equal(loss, f"phase 12 {label} {name} {dname} loss")
                if rank == 0:
                    lrel = abs(loss.item() - one[0]) / abs(one[0])
                    grel = ((whole - one[1]).norm() / one[1].norm()).item()
                    print(f"  {label} {name} {dname} step of {arch.depth} blocks at {TRAIN_B} x "
                          f"{TRAIN_N}: loss {loss.item():.6f} (one process {one[0]:.6f}, rel "
                          f"{lrel:.2e}), gradient rel L2 {grel:.3e} (bound {bound_:.0e})")
                    if not torch.isfinite(whole).all() or lrel > bound_ or grel > bound_:
                        fail(f"phase 12 {label} {name} {dname}: the sharded step disagrees with "
                             "one process")
                del grads, whole, local
                torch.cuda.empty_cache()

    def sharded_checkpoint(label: str, what: str, params, must_hold=()) -> None:
        """The tp 2 train state over `params` written as a sharded checkpoint
        and read back to the bit; its leaves must include every name of
        must_hold."""
        local = shard_params(params, tp_mesh)
        state = init_train_state(local, AdamW())
        missing = [n for n in must_hold if not any(n in k for k in ckpt.flatten_tree(local))]
        if missing:
            fail(f"phase 12 {label}: the train state lacks {missing}")
        tmp = Path(tempfile.mkdtemp()) if rank == 0 else None
        box = [str(tmp / "model_orbax") if tmp else None]
        dist.broadcast_object_list(box, src=0)
        path = box[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint_orbax(path, state.params, state.opt_state, state.ema_params,
                                   update=3, mesh=tp_mesh)
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
        zero = lambda tree: ckpt.unflatten_tree({  # noqa: E731
            k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0
            for k, v in ckpt.flatten_tree(tree).items()})
        t0 = time.perf_counter()
        got = ckpt.load_checkpoint_orbax(path, zero(state.params), zero(state.opt_state),
                                         zero(state.ema_params), mesh=tp_mesh)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for name in ("params", "opt_state", "ema_params"):
            for (k, a), b in zip(ckpt.flatten_tree(getattr(state, name)).items(),
                                 ckpt.flatten_tree(got[name]).values()):
                if not (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b):
                    fail(f"phase 12 {label}: {name}/{k} did not come back to the bit")
        dist.barrier()
        if rank == 0:
            size = sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file()) / 2**30
            held = f", {', '.join(must_hold)} among them" if must_hold else ""
            print(f"  {label} sharded checkpoint of {what} ({P12_DEPTH} blocks, params, Adam and "
                  f"EMA{held}): {size:.2f} GiB in {len(list(Path(path).iterdir()))} files, "
                  f"written in {t_write:.2f} s, read back in {t_load:.2f} s, equal to the bit")
            shutil.rmtree(tmp)
        dist.barrier()

    arch = dataclasses.replace(train_arch(), depth=P12_DEPTH)
    params = redraw_zero_init(init_dit(arch, seed=0, device=dev), seed=1)
    sharded_steps("(b)", arch, params,
                  lambda f32: expected_train_launches(1, P12_DEPTH, f32=f32))
    # (d) a sharded checkpoint of the tp 2 train state, written and read back
    sharded_checkpoint("(d)", "the tp 2 train state", params)
    del params
    torch.cuda.empty_cache()

    # (e) tensor-parallel sampling of E2TTS_Base (UNetT) and MMDiTConfig() at
    # full depth, bf16, the bench protocol; the MMDiT under attn_int8 "qkpv" too
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    inputs = bench_inputs(dev)
    e2 = dataclasses.replace(preset_model_config("E2TTS_Base").arch, text_num_embeds=2545)
    mm = MMDiTConfig(text_num_embeds=2545)
    for label, backbone, march, modes in (("E2TTS_Base", "UNetT", e2, (None,)),
                                          ("MMDiT", "MMDiT", mm, (None, "qkpv"))):
        model = load_model(ModelConfig(name=label, backbone=backbone, arch=march),
                           dtype=torch.bfloat16, seed=0, device=dev)
        redraw_zero_init(model.params, seed=1)
        local = shard_params(model.params, tp_mesh)
        per = march.depth * STEPS
        for attn_int8 in modes:
            mode = f"bf16 attn_int8 {attn_int8}" if attn_int8 else "bf16"
            attn = ({"flash_prefix_i8": per, "flash_prefix_i8_quant": per} if attn_int8
                    else {"flash_prefix": per})
            want = launches_of(**attn, grouped_conv=2 * STEPS)
            reset_launch_counts()
            t0 = time.perf_counter()
            mel, wav = synthesize(model, vocoder, inputs, params=local, attn_int8=attn_int8,
                                  mesh=tp_mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            print(f"  {tag} (e) {label} {mode}: launches "
                  f"{({k: v for k, v in counts.items() if v})}")
            if counts != want:
                fail(f"phase 12 (e) {label} {mode}: launches {counts}, expected {want}")
            if not (torch.isfinite(mel).all() and torch.isfinite(wav).all()):
                fail(f"phase 12 (e) {label} {mode}: non-finite mel or waveform")
            both_equal(mel, f"phase 12 (e) {label} {mode} mel")
            if rank == 0:
                one, _ = synthesize(model, vocoder, inputs, attn_int8=attn_int8)
                a, b = mel[:, :total].float(), one[:, :total].float()
                rel = ((a - b).norm() / b.norm()).item()
                print(f"  (e) tp 2 {label} ({march.depth} blocks) {mode}: mel rel L2 {rel:.3e} "
                      f"to one process (bound 5e-2), mean |mel| {b.abs().mean().item():.3f}; "
                      f"{ms:.1f} ms an utterance with both ranks on one card (gloo through the "
                      "host; a correctness run, no tensor-parallel speed)")
                if rel > 5e-2 or b.abs().max() == 0:
                    fail(f"phase 12 (e) {label} {mode}: tp 2 disagrees with one process")
        del model, local
        torch.cuda.empty_cache()
    del vocoder

    # (f) a step of each backbone at 8 blocks, no remat (the E2TTS configs'
    # and MMDiTConfig()'s): 10, 11 and 13 once a block
    def no_remat(f32: bool) -> dict[str, int]:
        f = "_f32" if f32 else ""
        return launches_of(**{f"flash_prefix_lse{f}": P12_DEPTH,
                              f"flash_prefix_dq_lsein{f}": P12_DEPTH,
                              f"flash_prefix_dkv{f}": P12_DEPTH})

    e2 = dataclasses.replace(e2, depth=P12_DEPTH)
    sharded_steps("(f) UNetT", e2, init_unett(e2, seed=4, device=dev), no_remat)
    torch.cuda.empty_cache()
    mm = dataclasses.replace(mm, depth=P12_DEPTH)
    params = redraw_zero_init(init_mmdit(mm, seed=4, device=dev), seed=5)
    sharded_steps("(f) MMDiT", mm, params, no_remat)
    # (g) the MMDiT's tp 2 train state as a sharded checkpoint
    sharded_checkpoint("(g)", "the MMDiT's tp 2 train state", params,
                       must_hold=("to_q_c", "to_out_c", "ff_c"))
    del params
    torch.cuda.empty_cache()
    split_heads_case(dev, rank, tp_mesh)
    dist.destroy_process_group()


def split_heads_case(dev, rank: int, mesh) -> None:
    """(i) 3 heads of 64 at tp 2, which the model axis does not divide: each
    rank gathers the group's q/k/v columns and runs kernel A on every head
    (10, 11, 13 under autograd), fp32. attention() under a duration mask and
    joint_attention() against one process on the card (rank 0): the outputs
    within F32_ATTN_REL, one backward's gradients (the weights' as one
    vector, x's, c's) within F32_GRAD_REL; each rank's launches exact."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import (
        attention,
        attention_init,
        joint_attention,
    )
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.parallel.mesh import shard_params, unshard_params
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree

    gen = torch.Generator(device=dev).manual_seed(21)
    full = attention_init(gen, 192, 3, 64, dev, context_dim=192)
    x = torch.randn((2, 1024, 192), generator=gen, device=dev)
    c = torch.randn((2, 160, 192), generator=gen, device=dev)
    gx = torch.randn(x.shape, generator=gen, device=dev)
    gc = torch.randn(c.shape, generator=gen, device=dev)
    mask = torch.arange(1024, device=dev)[None] < torch.tensor([1024, 900], device=dev)[:, None]

    def run(fn: str, m):
        p = {k: {n: v.detach().clone().requires_grad_() for n, v in lp.items()}
             for k, lp in (full if m is None else shard_params(full, m)).items()}
        xt, ct = x.clone().requires_grad_(), c.clone().requires_grad_()

        def call():
            if fn == "attention":
                return (attention(p, xt, 3, mask=mask, mesh=m),)
            return joint_attention(p, xt, ct, 3, mask=mask, mesh=m)

        reset_launch_counts()
        with torch.no_grad():
            fwd = call()
        outs = call()
        sum(((o * g).sum() for o, g in zip(outs, (gx, gc))), torch.zeros((), device=dev)).backward()
        torch.cuda.synchronize()
        counts = launch_counts()
        grads = {f"{k}/{n}": t.grad for k, lp in p.items() for n, t in lp.items()
                 if t.grad is not None}
        if m is not None:
            grads = flatten_tree(unshard_params(unflatten_tree(grads), m))
        return fwd, grads, xt.grad, ct.grad, counts

    for fn in ("attention", "joint_attention"):
        fwd, grads, gxt, gct, counts = run(fn, mesh)
        want = launches_of(flash_prefix_f32=1, flash_prefix_lse_f32=1,
                           flash_prefix_dq_lsein_f32=1, flash_prefix_dkv_f32=1)
        print(f"  [rank {rank}] (i) {fn}, 3 heads of 64 at tp 2: launches "
              f"{({k: v for k, v in counts.items() if v})}")
        if counts != want:
            fail(f"phase 12 (i) {fn}: launches {counts}, expected {want}")
        if rank != 0:
            continue
        fwd1, grads1, gx1, gc1, _ = run(fn, None)
        out_rel = max(_rel(a, b) for a, b in zip(fwd, fwd1))
        if grads.keys() != grads1.keys():
            fail(f"phase 12 (i) {fn}: gradients of {sorted(grads)}, expected {sorted(grads1)}")
        # the whole weight gradient: to_k's bias alone has a gradient of
        # rounding noise (a shift of every key leaves the softmax unchanged)
        pairs = [(torch.cat([grads[k].flatten() for k in grads1]),
                  torch.cat([grads1[k].flatten() for k in grads1])), (gxt, gx1)]
        if fn == "joint_attention":
            pairs.append((gct, gc1))
        grad_rel = max(_rel(a, b) for a, b in pairs)
        print(f"  (i) {fn}, 3 heads of 64 at tp 2 (a rank gathers the group's q/k/v columns) "
              f"against one process, fp32 on the kernels: outputs rel L2 {out_rel:.3e} (bound "
              f"{F32_ATTN_REL:.0e}), gradients (the weights' whole, x's, c's) at most "
              f"{grad_rel:.3e} (bound {F32_GRAD_REL:.0e})")
        if out_rel > F32_ATTN_REL or grad_rel > F32_GRAD_REL:
            fail(f"phase 12 (i) {fn}: tp 2 over undivided heads disagrees with one process")


def phase12_nccl(dev, card: str) -> None:
    """(c) make_mesh(1, 1) on NCCL at world size 1 (the init path of a card
    per rank): the collectives of both axes, and a step of 2 blocks under
    the mesh against the same step without one, to the bit."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.parallel.mesh import axis_group, make_mesh
    from korean_f5_tts_tpu_torch.train.step import loss_and_grads

    mesh = make_mesh(1, 1, device="cuda")
    backend = dist.get_backend()
    x = torch.arange(4.0, device=dev)
    for axis in ("data", "model"):
        dist.all_reduce(x, group=axis_group(mesh, axis))
    torch.cuda.synchronize()
    arch = dataclasses.replace(train_arch(), depth=2)
    params = redraw_zero_init(init_dit(arch, seed=0, device=dev), seed=1)
    batch = train_batch(dev)
    loss_m, g_m = loss_and_grads(params, batch, 5, arch, compute_dtype=torch.bfloat16, mesh=mesh)
    loss_0, g_0 = loss_and_grads(params, batch, 5, arch, compute_dtype=torch.bfloat16)
    same = loss_m.item() == loss_0.item() and all(torch.equal(a, b) for a, b in zip(g_m, g_0))
    print(f"  (c) make_mesh(1, 1): backend {backend}, world {dist.get_world_size()}, mesh "
          f"{tuple(mesh.shape)}, all-reduce over both axes {x.tolist()}; a step of 2 blocks "
          f"under the mesh equals one without it to the bit: {same} [{card}]")
    if backend != "nccl" or x.tolist() != [0.0, 1.0, 2.0, 3.0] or not same:
        fail("phase 12 (c): NCCL at world size 1")
    dist.destroy_process_group()


def phase12_train_paths(dev, card: str) -> dict[str, int]:
    """(h) training steps through kernels 7, 8 ("linear_fused", with 10, 11,
    13), 18 ("rope_in_kernel") and 19 ("qkv_kernel") under autograd against
    the plain versions, bf16 and fp32, with exact launches (full remat: each
    forward twice; 7 and 8 once per item, the attention once for the batch);
    then "dots" against "full", bf16 and fp32: gradients, step ms and peak
    GiB."""
    import dataclasses

    import torch

    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.train.step import loss_and_grads

    arch = dataclasses.replace(train_arch(), depth=P12_DEPTH)
    params = redraw_zero_init(init_dit(arch, seed=0, device=dev), seed=1)
    batch = train_batch(dev)
    total = dict.fromkeys(launch_counts(), 0)
    d = P12_DEPTH
    for attn_path in ("linear_fused", "rope_in_kernel", "qkv_kernel"):
        for dtype, bound_ in ((torch.bfloat16, TRAIN_REL), (None, F32_GRAD_REL)):
            f = "" if dtype else "_f32"
            want = launches_of(**{
                "linear_fused": {f"ln_mod_matmul{f}": 2 * TRAIN_B * d,
                                 f"proj_gated_residual{f}": 2 * TRAIN_B * d,
                                 f"flash_prefix_lse{f}": 2 * d, f"flash_prefix_dq_lsein{f}": d,
                                 f"flash_prefix_dkv{f}": d},
                "rope_in_kernel": {f"flash_prefix_rope{f}": 2 * d},
                "qkv_kernel": {f"flash_prefix_qkv{f}": 2 * d}}[attn_path])
            reset_launch_counts()
            loss_k, g_k = loss_and_grads(params, batch, 5, arch, compute_dtype=dtype,
                                         attn_path=attn_path)
            torch.cuda.synchronize()
            counts = launch_counts()
            if counts != want:
                fail(f"phase 12 (h) {attn_path}: launches {counts}, expected {want}")
            loss_p, g_p = loss_and_grads(params, batch, 5, arch, compute_dtype=dtype,
                                         attn_path=attn_path, kernels=False)
            gk = torch.cat([g.flatten().float() for g in g_k])
            gp = torch.cat([g.flatten().float() for g in g_p])
            grel = ((gk - gp).norm() / gp.norm()).item()
            lrel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
            print(f"  (h) {attn_path} {'bf16' if dtype else 'fp32'} step ({d} blocks, "
                  f"{TRAIN_B} x {TRAIN_N}): loss rel {lrel:.2e}, gradient rel L2 {grel:.3e} "
                  f"to plain (bound {bound_:.0e}); launches "
                  f"{({k: v for k, v in counts.items() if v})}")
            if not torch.isfinite(gk).all() or lrel > bound_ or grel > bound_:
                fail(f"phase 12 (h) {attn_path}: the step disagrees with the plain versions")
            total = {k: total[k] + counts[k] for k in total}
            del g_k, g_p, gk, gp
            torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, None):
        runs = {}
        for policy in ("full", "dots"):
            a = dataclasses.replace(arch, remat_policy=policy)
            loss_and_grads(params, batch, 5, a, compute_dtype=dtype)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                loss, grads = loss_and_grads(params, batch, 5, a, compute_dtype=dtype)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            runs[policy] = (loss.item(), torch.cat([g.flatten().float() for g in grads]),
                            min(times), torch.cuda.max_memory_allocated() / 2**30,
                            launch_counts())
            del grads
        (lf, gf, msf, pkf, cf), (ld, gd, msd, pkd, cd) = runs["full"], runs["dots"]
        grel = ((gd - gf).norm() / gf.norm()).item()
        lse = "flash_prefix_lse" + ("" if dtype else "_f32")
        print(f"  (h) remat 'dots' against 'full', {'bf16' if dtype else 'fp32'}, {d} blocks at "
              f"{TRAIN_B} x {TRAIN_N}: loss {ld:.6f} / {lf:.6f}, gradient rel L2 {grel:.3e}; "
              f"step {msd:.1f} / {msf:.1f} ms (min of 3), peak {pkd:.2f} / {pkf:.2f} GiB; "
              f"kernel 10 per step {cd[lse] // 3} / {cf[lse] // 3} [{card}]")
        # not to the bit: the embedding's backward adds with atomics, in another order a run
        if grel > 1e-3 or cd[lse] != 3 * d or cf[lse] != 6 * d:
            fail("phase 12 (h): 'dots' is not 'full' with the attention output kept")
        total = {k: total[k] + cd[k] + cf[k] for k in total}
        del gf, gd
    return total


def phase12_parallel(dev, card: str) -> dict[str, int]:
    """Phase 12: the two-rank part in two processes of this script on the one
    card (their lines relayed), then (c) and (h) in this process."""
    import os
    import socket

    print("phase 12: tensor-parallel serving, data- and tensor-parallel training, sharded "
          "checkpoints (two ranks on one card over gloo; the DiT, then the UNetT and the MMDiT), "
          "NCCL at world size 1, training through kernels 7, 8, 18, 19 and remat 'dots'")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "F5_TTS_DIST_COORDINATOR": f"localhost:{port}",
           "F5_TTS_DIST_NUM_PROCESSES": "2"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase12-rank",
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=P12_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log in logs:
        for line in log.splitlines():
            if line.startswith("  "):
                print(line)
    if any(p.returncode != 0 for p in procs):
        for log in logs:
            print(log[-3000:])
        fail("phase 12: a rank failed")
    print(f"  (a), (b), (d)-(g) in {time.perf_counter() - t0:.1f} s, both processes started "
          f"and ended [{card}]")
    phase12_nccl(dev, card)
    return phase12_train_paths(dev, card)


# ---------------------------------------------------------------------------
# head dim 128 (and 8 channels a conv-pos group): phase 2's checks of the
# forms and phase 13's paths
# ---------------------------------------------------------------------------


# the attention kernels' edges at d = 128 (64-row blocks, 64-key tiles): n 1,
# 63-65, 127-129, 1536; kv_len 0, 1, 63-65, n; keys past kv_len at +-1e4
D128_EDGES = (
    (1, [1, 0], None),
    (63, [0, 1, 63], None),
    (64, [1, 63, 64], None),
    (65, [0, 1, 63, 64, 65], 1e4),
    (127, [1, 65, 127], None),
    (128, [0, 1, 64, 127, 128], None),
    (129, [1, 63, 64, 65, 128, 129], 1e4),
    (1536, [0, 1, 65, 1376, 1536], 1e4),
)
# kernel 14 at d = 128: (B, heads, n, kv_lens, keys and values past kv_len),
# the tiles' edges and the 512-key chunk's (several chunks, kv_len inside the
# last one, on a chunk boundary and at n)
I8_D128_EDGES = (
    (1, 2, 1, [1], 0.0),
    (2, 2, 63, [0, 63], 0.0),
    (2, 2, 64, [1, 64], 1e4),
    (2, 2, 65, [64, 65], 0.0),
    (3, 2, 127, [0, 1, 127], 1e4),
    (2, 2, 129, [128, 129], 0.0),
    (2, 2, 513, [511, 513], 1e4),
    (3, 2, 640, [600, 512, 640], 1e4),
    (2, 8, 1536, [1376, 1536], 1e4),
)
# kernels A and 18 at d = 128 in bf16 on the attention core (128 rows a
# block, 64- or 128-key tiles): (heads, n, kv_lens, keys past kv_len), n 1,
# 129, 1537; kv_len 0, 1, 127, 128, 129, n; 23 heads at n 1536: 276 blocks,
# a partial wave on 132 SMs
CORE_D128_EDGES = (
    (2, 1, [1, 0], None),
    (6, 129, [0, 1, 127, 128, 129, 64], 1e4),
    (6, 1537, [0, 1, 127, 128, 129, 1537], 1e4),
    (23, 1536, [0, 1, 127, 128, 129, 1376, 1536] * 3 + [700, 1535], 1e4),
)
# kernels A and 18 at d = 128 in fp32 on split 3xTF32 (128 rows a block,
# 32-key tiles): (n, kv_lens, keys past kv_len); n 1, 127-129, 1537; kv_len
# 0, 1, the tile's edge (31-33), n
TF32_D128_EDGES = (
    (1, [1, 0], None),
    (127, [31, 32, 33, 127, 0], 1e4),
    (128, [1, 31, 32, 33, 128], None),
    (129, [0, 31, 32, 33, 129, 64], 1e4),
    (1537, [1537, 33, 32, 31, 1], 1e4),
)
# kernels 11, 12 and 13 at d = 128 in fp32 on split 3xTF32 (dq: 128 queries a
# block, 32-key tiles; dk, dv: 64 keys a block, 32-query tiles): (n, kv_lens,
# keys past kv_len); n 1, 31-33, 63-65, 127-129, 1537; kv_len 0, 1, 31-33,
# 63-65, n; 23 heads at n 1537: 299 dq and 575 dk, dv blocks, partial waves on
# 132 SMs
TF32_BWD_D128_EDGES = (
    (1, [1, 0], None),
    (31, [0, 1, 31], 1e4),
    (32, [1, 31, 32], None),
    (33, [0, 31, 32, 33], 1e4),
    (63, [1, 33, 63, 0], None),
    (64, [0, 63, 64, 32], 1e4),
    (65, [1, 63, 64, 65, 33], 1e4),
    (127, [127, 0, 31, 65], 1e4),
    (128, [128, 1, 32, 64, 63], None),
    (129, [129, 0, 1, 63, 65, 128], 1e4),
    (1537, [1537, 33, 64, 0, 1, 65, 31, 32] * 2 + [1537] * 7, 1e4),
)
# kernel 13 at d = 128 in bf16 on the attention backward core (128 keys a
# block on two warpgroups of 64, 64-query tiles): (n, kv_lens, keys past
# kv_len); n 100 and 301 (an [H, n] row of lse and D at no 16-byte boundary),
# kv_len 0, 1, 63-65, 127-129, n; 23 heads at n 1537: 299 blocks, a partial
# wave on 132 SMs
CORE_BWD_D128_EDGES = (
    (100, [1, 63, 64, 65, 100, 0], None),
    (301, [1, 63, 64, 65, 127, 128, 129, 301], 1e4),
    (301, [0, 129, 200, 301], None),
    (1537, [1537, 0, 1, 63, 64, 65, 127, 128, 129, 700, 1536] * 2 + [1537], 1e4),
)
# kernels 11 and 12 at d = 128 in bf16 on the backward core's dq form (128
# queries a block on two warpgroups of 64, 64-key tiles): (n, kv_lens, keys
# past kv_len); n 1, 63-65, 127-129, 301 (an [H, n] row of lse and D at no
# 16-byte boundary), 1537; kv_len 0, 1, 63-65, 127-129, n; 23 heads at n 1537:
# 299 blocks, a partial wave on 132 SMs
CORE_DQ_D128_EDGES = (
    (1, [1, 0], None),
    (63, [0, 1, 63], 1e4),
    (64, [1, 63, 64], None),
    (65, [0, 1, 63, 64, 65], 1e4),
    (127, [1, 65, 127, 0], None),
    (128, [0, 1, 64, 127, 128], 1e4),
    (129, [1, 63, 64, 65, 127, 128, 129], 1e4),
    (301, [1, 63, 64, 65, 127, 128, 129, 301, 0], 1e4),
    (1537, [1537, 0, 1, 63, 64, 65, 127, 128, 129, 700, 1536] * 2 + [1537], 1e4),
)
SERVE_D128 = (16, 1536, 1376)  # folded heads (2 items x 8), n, kv_len: the serving shape
TRAIN_D128 = (64, 1280)        # folded heads (8 items x 8), n: the training shape


def _d128_tag(dtype) -> tuple[str, str, float, float]:
    """(counter suffix, label, o bound, gradient bound) of a dtype's forms."""
    import torch

    if dtype == torch.float32:
        return "_f32", "fp32", F32_ATTN_REL, F32_GRAD_REL
    return "", "bf16", 1e-2, 1e-2


def _d128_kept(entry: str, dev, q, k, v, kv, cos=None, sin=None, heads=1, n_rope=0,
               lse: bool = False):
    """Kernel A (cos None: q, k, v [H, n, 128], kv [H]), 10 (lse: A and its
    lse [H, n]) or 18 (q, k, v [B, heads, n, 128], kv [B], cos, sin [n, 64]
    of the operands' dtype) on a d = 128 design that no path runs any more,
    kept for timing (entry: "mma", the bf16 mma.sync loop; "ffma", the fp32
    FFMA kernel). Not counted: the counters are the wrappers'."""
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    lib, stream = cuda_build.library(), torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    lse_t = torch.empty(q.shape[:2], dtype=torch.float32, device=dev) if lse else None
    fn = lib.f5_flash_prefix_d128_fwd_mma if entry == "mma" else lib.f5_flash_prefix_f32_d128_fwd_ffma
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
             None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
             out.data_ptr(), None if lse_t is None else lse_t.data_ptr(), q.shape[0], heads,
             q.shape[-2], n_rope, fp.LOG2E / 128 ** 0.5, dev.index, stream)
    form = "A" if cos is None else "18"
    cuda_build.check(err, f"kernel {'10' if lse else form} d = 128 on the {entry} design")
    return (out, lse_t) if lse else out


def d128_mma(dev, q, k, v, kv, cos=None, sin=None, heads=1, n_rope=0, lse: bool = False):
    """Kernel A, 10 (lse) or 18 in bf16 on the mma.sync loop the attention
    core replaced (f5_flash_prefix_d128_fwd_mma; _d128_kept)."""
    return _d128_kept("mma", dev, q, k, v, kv, cos, sin, heads, n_rope, lse)


def d128_ffma(dev, q, k, v, kv, cos=None, sin=None, heads=1, n_rope=0, lse: bool = False):
    """Kernel A, 10 (lse) or 18 in fp32 on the FFMA kernel the split 3xTF32
    kernel replaced (f5_flash_prefix_f32_d128_fwd_ffma; _d128_kept)."""
    return _d128_kept("ffma", dev, q, k, v, kv, cos, sin, heads, n_rope, lse)


def d128_designs_timed(label: str, ms: float, old, r: dict, shape: str = "serving",
                       old_name: str = "the mma.sync loop", new_name: str = "the attention core",
                       most: float = 0.5) -> None:
    """The new design's time (the wrapper's, ms) beside the design it
    replaced (old()), one process, one timer (cuda_time_ms); the new one
    must take at most `most` of the old one's time."""
    old_ms = cuda_time_ms(old)
    lib_ms = r.get("library_ms")
    print(f"  {label} designs at the {shape} shape, one process: {new_name} (the wrapper) "
          f"{ms:.4f} ms, {old_name} {old_ms:.4f} ms ({old_ms / ms:.2f}x the new one's); bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / ms:.3f} of the new one's time), plain "
          f"{r['plain_ms']:.4f} ms, library "
          + ("none of its own" if lib_ms is None else f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"))
    r["old_design_ms"] = old_ms
    if ms > most * old_ms:
        fail(f"{label} on {new_name} takes {ms:.4f} ms, more than {most:.3g} of {old_name}'s "
             f"{old_ms:.4f} ms")


def d128_f32_designs_timed(label: str, ms: float, ffma, r: dict, shape: str = "serving") -> None:
    """d128_designs_timed for an fp32 form on split 3xTF32: at most two thirds
    of the FFMA kernel's time."""
    d128_designs_timed(label, ms, ffma, r, shape=shape, old_name="the FFMA kernel",
                       new_name="split 3xTF32", most=2 / 3)


def _d128_kept_bwd(entry: str, dev, form: int, q, k, v, do, dvec, lse, kv):
    """Kernel 11 (form 11: dq from lse), 12 (form 12: (dq, lse), lse None)
    or 13 (form 13: (dk, dv)) at d = 128 on a kept design (entry: "mma",
    the bf16 mma.sync kernels the backward core's D = 128 forms replaced,
    f5_flash_prefix_d128_bwd_mma; "ffma", the fp32 FFMA kernels the split
    3xTF32 kernels replaced,
    f5_flash_prefix_f32_d128_bwd_ffma). Not counted: the counters are the
    wrappers'."""
    import torch

    from korean_f5_tts_tpu_torch.ops import cuda_build
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    lib = cuda_build.library()
    fn = lib.f5_flash_prefix_d128_bwd_mma if entry == "mma" else lib.f5_flash_prefix_f32_d128_bwd_ffma
    H, n = q.shape[:2]
    out0 = torch.empty_like(q)
    out1 = (torch.empty((H, n), dtype=torch.float32, device=dev) if form == 12
            else torch.empty_like(v) if form == 13 else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
             None if lse is None else lse.data_ptr(), kv.data_ptr(), out0.data_ptr(),
             None if out1 is None else out1.data_ptr(), H, n, form, fp.LOG2E / 128 ** 0.5,
             128 ** -0.5, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, f"kernel {form} d = 128 on the {entry} design")
    return out0 if out1 is None else (out0, out1)


def d128_ffma_bwd(dev, form: int, q, k, v, do, dvec, lse, kv):
    """_d128_kept_bwd on the fp32 FFMA kernels."""
    return _d128_kept_bwd("ffma", dev, form, q, k, v, do, dvec, lse, kv)


def d128_mma_bwd(dev, form: int, q, k, v, do, dvec, lse, kv):
    """_d128_kept_bwd on the bf16 mma.sync kernels (11, 12 and 13: the ones
    the backward core's D = 128 forms replaced)."""
    return _d128_kept_bwd("mma", dev, form, q, k, v, do, dvec, lse, kv)


def check_core_d128(gen, dev) -> None:
    """Kernels A and 10 at d = 128 in bf16 on the attention core at its
    tiles' edges (CORE_D128_EDGES) against the plain version, o within 1e-2
    and 10's lse within F32_ATTN_REL, the mma.sync loop they replaced beside
    (10 with its lse); 10's o is A's to the bit (one core, one key tile); a
    head with kv_len 0 gives zeros and lse 0."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    print("kernels A and 10 d = 128 bf16 on the attention core at its edges (rel bound 1e-2, "
          f"lse {F32_ATTN_REL:.0e}; the mma.sync loop beside; 10's o equal to A's)")
    for H, n, lens, past in CORE_D128_EDGES:
        q, k, v = (torch.randn((H, n, 128), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        for h, L in enumerate(lens if past else ()):
            k[h, L:] = past * q[h].float().mean(0).sign().to(torch.bfloat16)
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        want = fp.prefix_attention_reference(q, k, v, kv)
        want[kv == 0] = 0
        label = f"H={H} n={n} kv={lens if H < 8 else 'mixed'}{' past +-1e4' if past else ''}"
        got = fp.flash_prefix_folded(q, k, v, kv)
        compare(f"kernel A d=128 core {label}", got, want, 1e-2)
        compare(f"kernel A d=128 mma.sync {label}", d128_mma(dev, q, k, v, kv), want, 1e-2)
        lse_w = fp.prefix_attention_lse_reference(q, k, v, kv)[1]
        o10, lse10 = fp.flash_prefix_folded_lse(q, k, v, kv)
        compare(f"kernel 10 d=128 core o {label}", o10, want, 1e-2)
        compare(f"kernel 10 d=128 core lse {label}", lse10, lse_w, F32_ATTN_REL)
        o_m, lse_m = d128_mma(dev, q, k, v, kv, lse=True)
        compare(f"kernel 10 d=128 mma.sync o {label}", o_m, want, 1e-2)
        compare(f"kernel 10 d=128 mma.sync lse {label}", lse_m, lse_w, F32_ATTN_REL)
        torch.cuda.synchronize()
        if not torch.equal(o10, got):
            fail(f"kernel 10 d=128 {label}: its o is not kernel A's to the bit")
        if (kv == 0).any() and max(t[kv == 0].abs().max().item() for t in (got, o10, lse10)) != 0:
            fail(f"kernels A, 10 d=128 {label}: a head with kv_len 0 is not zero")


def check_attention_d128(gen, dev) -> dict[str, dict]:
    """Kernels A, 10, 11, 12 and 13 at d = 128 (bf16: A and 10 on the
    attention core's d = 128 form, csrc/attn_wgmma.cuh, 11, 12 and 13 on the
    backward core's D = 128 forms, csrc/flash_prefix_bwd_core_d128.cu;
    fp32: A and 10 on split 3xTF32,
    csrc/flash_prefix_tf32_d128.cu, 11-13 on split 3xTF32,
    csrc/flash_prefix_train_tf32_d128.cu; 10's o equal to A's to the bit in
    both dtypes; A and 10 fp32 also at the 3xTF32 tile's edges,
    TF32_D128_EDGES, 11-13 fp32 at theirs, TF32_BWD_D128_EDGES, 13 bf16
    at the backward core's, CORE_BWD_D128_EDGES, and 11 and 12 bf16 at its
    dq form's, CORE_DQ_D128_EDGES, with the designs they replaced beside,
    the fp32 forms of A, 10 and 11-13 timed beside the FFMA kernels at most
    2/3 of their time, 13 bf16 beside the mma.sync kernel at most 2/3, 11
    and 12 bf16 beside theirs at most 1/2)
    against their plain versions, both
    dtypes, at the serving shape (A: 16 heads, n 1536, 1376 keys), the
    training shape (10-13: 64 heads, n 1280, every key valid), a ragged case
    and D128_EDGES; bf16 o and gradients within 1e-2, fp32 o and lse within
    F32_ATTN_REL and gradients within F32_GRAD_REL, with a TF32 control that
    must fail those; a head with kv_len 0 gives zeros and lse 0. Each form
    timed beside its bound, its plain version and the library call."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        f, name, rel_o, rel_g = _d128_tag(dtype)

        def inputs(H, n, lens, past=None):
            q, k, v, do = (torch.randn((H, n, 128), generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            if past is not None:  # keys past kv_len that win every max unless masked first
                for h, L in enumerate(lens):
                    k[h, L:] = past * q[h].float().mean(0).sign().to(dtype)
            return q, k, v, do, torch.as_tensor(lens, dtype=torch.int32, device=dev)

        def plain(q, k, v, do, kv):
            o, lse = fp.prefix_attention_lse_reference(q, k, v, kv)
            o[kv == 0] = 0  # no valid key: zeros (the kernels'), not the plain uniform mean
            dvec = (do.float() * o.float()).sum(-1)
            dq = fp.flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv)
            return o, lse, dvec, dq, *fp.flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv)

        def case(label, H, n, lens, past=None):
            q, k, v, do, kv = inputs(H, n, lens, past)
            o, lse, dvec, dq_p, dk_p, dv_p = plain(q, k, v, do, kv)
            label = f"d=128 {name} {label}"
            oa = fp.flash_prefix_folded(q, k, v, kv)
            err = {"flash_prefix": compare(f"kernel A {label}", oa, o, rel_o)[0]}
            o10, lse10 = fp.flash_prefix_folded_lse(q, k, v, kv)
            err["flash_prefix_lse"] = compare(f"kernel 10 o {label}", o10, o, rel_o)[0]
            compare(f"kernel 10 lse {label}", lse10, lse, F32_ATTN_REL)
            if not torch.equal(o10, oa):  # one kernel, one key tile, the lse only added
                fail(f"kernel 10 {label}: its o is not kernel A's to the bit")
            zero = n == 1  # dq and dk are identically zero there (compare's note)
            dq11 = fp.flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv)
            err["flash_prefix_dq_lsein"] = compare(f"kernel 11 dq {label}", dq11, dq_p, rel_g,
                                                   zero=zero)[0]
            dq12, lse12 = fp.flash_prefix_dq(q, k, v, do, dvec, kv)
            err["flash_prefix_dq"] = compare(f"kernel 12 dq {label}", dq12, dq_p, rel_g,
                                             zero=zero)[0]
            compare(f"kernel 12 lse {label}", lse12, lse, F32_ATTN_REL)
            dk, dv = fp.flash_prefix_dkv(q, k, v, do, dvec, lse, kv)
            err["flash_prefix_dkv"] = max(
                compare(f"kernel 13 dk {label}", dk, dk_p, rel_g, zero=zero)[0],
                compare(f"kernel 13 dv {label}", dv, dv_p, rel_g)[0])
            torch.cuda.synchronize()
            none = kv == 0
            if none.any():
                worst = max(t[none].abs().max().item()
                            for t in (oa, o10, lse10, dq11, dq12, lse12, dk, dv))
                if worst != 0:
                    fail(f"the d = 128 forms {label}: a head with kv_len 0 is not zero")
            return err, (q, k, v, do, kv, o, lse, dvec, dq_p, dk_p, dv_p)

        print(f"kernels A, 10-13 at d = 128, {name} ("
              f"{'A, 10 on the attention core, 11-13 on the backward core' if not f else 'A, 10-13 split 3xTF32'}"
              f"; rel bound {rel_o:.0e} for o, {F32_ATTN_REL:.0e} for lse, {rel_g:.0e} for dq, "
              "dk, dv)")
        H, n = TRAIN_D128
        errs, main = case(f"training main H={H} n={n} kv=n", H, n, [n] * H)
        q, k, v, do, kv, o, lse, dvec, dq_p, dk_p, dv_p = main
        mixed = torch.randint(1, 1201, (8,), generator=gen, device=dev).tolist()
        case(f"ragged H=8 n=1200 kv={mixed}", 8, 1200, mixed)
        for n_, lens, past in D128_EDGES:
            case(f"edge n={n_} kv={lens}{' keys past kv_len at +-1e4' if past else ''}",
                 len(lens), n_, lens, past)
        for n_, lens, past in TF32_D128_EDGES if f else ():  # A, 10 on split 3xTF32, its edges
            qe, ke, ve, _, kve = inputs(len(lens), n_, lens, past)
            want, lse_w = fp.prefix_attention_lse_reference(qe, ke, ve, kve)
            want[kve == 0] = 0
            label = f"d=128 fp32 3xTF32 edge n={n_} kv={lens}{' past +-1e4' if past else ''}"
            got = fp.flash_prefix_folded(qe, ke, ve, kve)
            compare(f"kernel A {label}", got, want, rel_o)
            compare(f"kernel A FFMA {label}", d128_ffma(dev, qe, ke, ve, kve), want, rel_o)
            o10, lse10 = fp.flash_prefix_folded_lse(qe, ke, ve, kve)
            compare(f"kernel 10 o {label}", o10, want, rel_o)
            compare(f"kernel 10 lse {label}", lse10, lse_w, F32_ATTN_REL)
            o_f, lse_f = d128_ffma(dev, qe, ke, ve, kve, lse=True)
            compare(f"kernel 10 FFMA o {label}", o_f, want, rel_o)
            compare(f"kernel 10 FFMA lse {label}", lse_f, lse_w, F32_ATTN_REL)
            torch.cuda.synchronize()
            if not torch.equal(o10, got):
                fail(f"kernel 10 {label}: its o is not kernel A's to the bit")
            if (kve == 0).any() and max(t[kve == 0].abs().max().item()
                                        for t in (got, o10, lse10)) != 0:
                fail(f"kernels A, 10 {label}: a head with kv_len 0 is not zero")
        for n_, lens, past in CORE_BWD_D128_EDGES if not f else ():  # 13 on the backward core
            qe, ke, ve, doe, kve = inputs(len(lens), n_, lens, past)
            _, lse_e, dvec_e, _, dk_w, dv_w = plain(qe, ke, ve, doe, kve)
            label = (f"d=128 bf16 backward core edge H={len(lens)} n={n_} "
                     f"kv={lens if len(lens) < 12 else 'mixed'}{' past +-1e4' if past else ''}")
            args = (qe, ke, ve, doe, dvec_e, lse_e, kve)
            dk, dv = fp.flash_prefix_dkv(*args)
            mdk, mdv = d128_mma_bwd(dev, 13, *args)
            for name_, got, want in (("13 dk", dk, dk_w), ("13 dv", dv, dv_w),
                                     ("13 mma.sync dk", mdk, dk_w), ("13 mma.sync dv", mdv, dv_w)):
                compare(f"kernel {name_} {label}", got, want, rel_g)
            torch.cuda.synchronize()
            none = kve == 0
            if none.any() and max(t[none].abs().max().item() for t in (dk, dv)) != 0:
                fail(f"kernel 13 {label}: a head with kv_len 0 is not zero")
        for n_, lens, past in CORE_DQ_D128_EDGES if not f else ():  # 11, 12 on the backward core
            qe, ke, ve, doe, kve = inputs(len(lens), n_, lens, past)
            _, lse_e, dvec_e, dq_w, _, _ = plain(qe, ke, ve, doe, kve)
            label = (f"d=128 bf16 backward core dq edge H={len(lens)} n={n_} "
                     f"kv={lens if len(lens) < 12 else 'mixed'}{' past +-1e4' if past else ''}")
            args = (qe, ke, ve, doe, dvec_e, lse_e, kve)
            dq11 = fp.flash_prefix_dq_lsein(*args)
            dq12, lse12 = fp.flash_prefix_dq(qe, ke, ve, doe, dvec_e, kve)
            m11 = d128_mma_bwd(dev, 11, *args)
            m12, ml12 = d128_mma_bwd(dev, 12, qe, ke, ve, doe, dvec_e, None, kve)
            zero = n_ == 1  # dq is identically zero there (compare's note)
            for name_, got, want, bound_, z in (
                    ("11 dq", dq11, dq_w, rel_g, zero), ("12 dq", dq12, dq_w, rel_g, zero),
                    ("12 lse", lse12, lse_e, F32_ATTN_REL, False),
                    ("11 mma.sync dq", m11, dq_w, rel_g, zero),
                    ("12 mma.sync dq", m12, dq_w, rel_g, zero),
                    ("12 mma.sync lse", ml12, lse_e, F32_ATTN_REL, False)):
                compare(f"kernel {name_} {label}", got, want, bound_, zero=z)
            torch.cuda.synchronize()
            none = kve == 0
            if none.any() and max(t[none].abs().max().item() for t in (dq11, dq12, lse12)) != 0:
                fail(f"kernels 11, 12 {label}: a head with kv_len 0 is not zero")
        for n_, lens, past in TF32_BWD_D128_EDGES if f else ():  # 11-13 on split 3xTF32
            qe, ke, ve, doe, kve = inputs(len(lens), n_, lens, past)
            _, lse_e, dvec_e, dq_w, dk_w, dv_w = plain(qe, ke, ve, doe, kve)
            label = (f"d=128 fp32 3xTF32 edge H={len(lens)} n={n_} "
                     f"kv={lens if len(lens) < 8 else 'mixed'}{' past +-1e4' if past else ''}")
            args = (qe, ke, ve, doe, dvec_e, lse_e, kve)
            dq11 = fp.flash_prefix_dq_lsein(*args)
            dq12, lse12 = fp.flash_prefix_dq(qe, ke, ve, doe, dvec_e, kve)
            dk, dv = fp.flash_prefix_dkv(*args)
            f11 = d128_ffma_bwd(dev, 11, *args)
            f12, fl12 = d128_ffma_bwd(dev, 12, qe, ke, ve, doe, dvec_e, None, kve)
            fdk, fdv = d128_ffma_bwd(dev, 13, *args)
            zero = n_ == 1  # dq and dk are identically zero there (compare's note)
            for name_, got, want, bound_, z in (
                    ("11 dq", dq11, dq_w, rel_g, zero), ("12 dq", dq12, dq_w, rel_g, zero),
                    ("12 lse", lse12, lse_e, F32_ATTN_REL, False), ("13 dk", dk, dk_w, rel_g, zero),
                    ("13 dv", dv, dv_w, rel_g, False), ("11 FFMA dq", f11, dq_w, rel_g, zero),
                    ("12 FFMA dq", f12, dq_w, rel_g, zero),
                    ("12 FFMA lse", fl12, lse_e, F32_ATTN_REL, False),
                    ("13 FFMA dk", fdk, dk_w, rel_g, zero),
                    ("13 FFMA dv", fdv, dv_w, rel_g, False)):
                compare(f"kernel {name_} {label}", got, want, bound_, zero=z)
            torch.cuda.synchronize()
            none = kve == 0
            if none.any() and max(t[none].abs().max().item()
                                  for t in (dq11, dq12, lse12, dk, dv)) != 0:
                fail(f"kernels 11-13 {label}: a head with kv_len 0 is not zero")
        if f:  # the control: the same plain versions with TF32 on fail the bounds
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                o_t, _, _, dq_t, dk_t, dv_t = plain(q, k, v, do, kv)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            ctl = {"o": (_rel(o_t, o), F32_ATTN_REL), "dq": (_rel(dq_t, dq_p), F32_GRAD_REL),
                   "dk": (_rel(dk_t, dk_p), F32_GRAD_REL), "dv": (_rel(dv_t, dv_p), F32_GRAD_REL)}
            print("  control, the plain versions with TF32 on against TF32 off at the training "
                  "shape: " + ", ".join(f"{nm} {r:.3e} (must fail {bd:.0e})"
                                        for nm, (r, bd) in ctl.items()))
            if any(r <= bd for r, bd in ctl.values()):
                fail("the TF32 control passes the fp32 bounds at d = 128")

        kind = "fp32" if f else "bf16"
        train = (q, k, v, do, dvec, lse, kv)
        timed = {
            "flash_prefix_lse": (lambda: fp.flash_prefix_folded_lse(q, k, v, kv),
                                 lambda: fp.prefix_attention_lse_reference(q, k, v, kv), 4,
                                 (q, k, v, kv, q, lse)),
            "flash_prefix_dq_lsein": (lambda: fp.flash_prefix_dq_lsein(*train),
                                      lambda: fp.flash_prefix_dq_lsein_reference(*train), 6,
                                      (*train, q)),
            "flash_prefix_dq": (lambda: fp.flash_prefix_dq(q, k, v, do, dvec, kv),
                                lambda: fp.flash_prefix_dq_reference(q, k, v, do, dvec, kv), 6,
                                (q, k, v, do, dvec, kv, q, lse)),
            "flash_prefix_dkv": (lambda: fp.flash_prefix_dkv(*train),
                                 lambda: fp.flash_prefix_dkv_reference(*train), 8,
                                 (*train, k, v)),
        }
        for base, (fn, plain_fn, products, io) in timed.items():
            print(f"  {base}{f}_d128 at the training shape:")
            out[f"{base}{f}_d128"] = {"max_abs_err": errs[base],
                                      **_timed(fn, plain_fn, products * H * n * n * 128, io,
                                               kind=kind)}
        if f:  # PyTorch's memory-efficient attention on fp32: forward with lse, backward
            aten = torch.ops.aten
            q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
            fwd = lambda: aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True, 0.0, False, scale=128 ** -0.5)
            lo = fwd()[0]
            print(f"  library forward (efficient attention, fp32): o rel {_rel(lo[0], o):.3e}")
            lib_fwd = cuda_time_ms(fwd)
            from torch.nn.attention import SDPBackend, sdpa_kernel

            leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                                           scale=128 ** -0.5)
            bwd = lambda: torch.autograd.grad(lib_out, leaves, do4, retain_graph=True)
            print(f"  library backward: dq rel {_rel(bwd()[0][0], dq_p):.3e}")
            lib_bwd = cuda_time_ms(bwd)
            del leaves, lib_out
        else:
            lib_fwd, lib_bwd = flash_library_times(q, k, v, do, kv, lse, dvec)
        out[f"flash_prefix_lse{f}_d128"]["library_ms"] = lib_fwd
        out[f"flash_prefix_dkv{f}_d128"]["library_ms"] = lib_bwd  # 11 + 13 together
        if not f:  # 10 on the attention core beside the mma.sync loop with its lse
            d128_designs_timed("kernel 10 d=128 bf16", out["flash_prefix_lse_d128"]["ms"],
                               lambda: d128_mma(dev, q, k, v, kv, lse=True),
                               out["flash_prefix_lse_d128"], shape="training")
            # 13 on the backward core beside the mma.sync kernel it replaced
            d128_designs_timed("kernel 13 d=128 bf16 (library: 11 + 13's backward)",
                               out["flash_prefix_dkv_d128"]["ms"],
                               lambda: d128_mma_bwd(dev, 13, *train), out["flash_prefix_dkv_d128"],
                               shape="training", new_name="the backward core", most=2 / 3)
            # 11 and 12 on the backward core's dq form beside the mma.sync kernel
            for base, form, old in (
                    ("flash_prefix_dq_lsein", 11, lambda: d128_mma_bwd(dev, 11, *train)),
                    ("flash_prefix_dq", 12,
                     lambda: d128_mma_bwd(dev, 12, q, k, v, do, dvec, None, kv))):
                d128_designs_timed(f"kernel {form} d=128 bf16", out[f"{base}_d128"]["ms"], old,
                                   out[f"{base}_d128"], shape="training",
                                   old_name="the mma.sync kernel", new_name="the backward core",
                                   most=0.5)
        if f:  # 10 on split 3xTF32 beside the FFMA kernel with its lse
            d128_f32_designs_timed("kernel 10 d=128 fp32", out["flash_prefix_lse_f32_d128"]["ms"],
                                   lambda: d128_ffma(dev, q, k, v, kv, lse=True),
                                   out["flash_prefix_lse_f32_d128"], shape="training")
        if f:  # 11, 12 and 13 on split 3xTF32 beside the FFMA kernels they replaced
            for base, form, old in (
                    ("flash_prefix_dq_lsein", 11, lambda: d128_ffma_bwd(dev, 11, *train)),
                    ("flash_prefix_dq", 12,
                     lambda: d128_ffma_bwd(dev, 12, q, k, v, do, dvec, None, kv)),
                    ("flash_prefix_dkv", 13, lambda: d128_ffma_bwd(dev, 13, *train))):
                r = out[f"{base}_f32_d128"]
                d128_f32_designs_timed(f"kernel {form} d=128 fp32"
                                       + (" (library: 11 + 13's backward)" if form == 13 else ""),
                                       r["ms"], old, r, shape="training")
        both = out[f"flash_prefix_dq_lsein{f}_d128"]["ms"] + out[f"flash_prefix_dkv{f}_d128"]["ms"]
        print(f"  library: forward {lib_fwd:.4f} ms (10 {out[f'flash_prefix_lse{f}_d128']['ms']:.4f}"
              f" ms), backward {lib_bwd:.4f} ms (11 + 13 {both:.4f} ms)")

        # kernel A at the serving shape, beside the library on sliced keys
        Hs, ns, L = SERVE_D128
        q, k, v, _, kv = inputs(Hs, ns, [L] * Hs)
        want = fp.prefix_attention_reference(q, k, v, kv)
        got = fp.flash_prefix_folded(q, k, v, kv)
        err = compare(f"kernel A d=128 {name} serving main H={Hs} n={ns} kv={L}", got, want,
                      rel_o)[0]
        print(f"  flash_prefix{f}_d128 at the serving shape:")
        r = _timed(lambda: fp.flash_prefix_folded(q, k, v, kv),
                   lambda: fp.prefix_attention_reference(q, k, v, kv),
                   4.0 * Hs * ns * L * 128, (q, k, v, kv, got), kind=kind)
        if f:
            call = efficient_f32_sliced(q, k, v, kv)
            print(f"  library: efficient attention on sliced keys, rel {_rel(call(), want):.1e}")
            r["library_ms"] = cuda_time_ms(call)
        else:
            r["library_ms"] = min(ms for ms, _ in sdpa_times(q, k, v, kv, want).values())
        print(f"  kernel A d=128 {name}: {r['ms']:.4f} ms, library {r['library_ms']:.4f} ms")
        if f:
            d128_f32_designs_timed("kernel A d=128 fp32", r["ms"],
                                   lambda: d128_ffma(dev, q, k, v, kv), r)
        else:
            d128_designs_timed("kernel A d=128 bf16", r["ms"],
                               lambda: d128_mma(dev, q, k, v, kv), r)
        out[f"flash_prefix{f}_d128"] = {"max_abs_err": err, **r}
        del q, k, v, do, main, train, timed
        torch.cuda.empty_cache()
    return out


def check_rope_d128(gen, dev) -> dict[str, dict]:
    """Kernel 18 at d = 128 (the attention core's d = 128 rope form in bf16,
    split 3xTF32 in fp32) against its plain version (rope_reference's
    rounding, then the prefix attention) and against kernel A on
    rope_reference-roped inputs, to the bit (the rotation is the only
    difference), at the serving shape ([2, 8, 1536, 128], 1376 keys) and at
    edges (pe_attn_head; kv_len 0, 1, 127-129, n; n 1, 65, 129, 1000, 1537;
    keys past kv_len at +-1e4; 24 heads, a partial wave; n 127, 128 and
    kv_len 31-33, the 3xTF32 tile's edges); timed beside the design it
    replaced (bf16: the mma.sync loop; fp32: the FFMA kernel)."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import rope_cos_sin
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    out = {}
    # the serving shape, the mma.sync loop's edges and the core's (n 1, 129,
    # 1537; kv_len 0, 1, 127, 128, 129, n; 24 heads at n 1536: a partial wave)
    cases = ((2, 8, 1536, [1376, 1376], None, None), (3, 2, 65, [0, 65, 1], 1, 1e4),
             (2, 2, 129, [128, 129], None, 1e4), (1, 4, 1, [1], 2, None),
             (2, 2, 1000, [1000, 63], None, None), (3, 2, 129, [0, 1, 127], 1, 1e4),
             (2, 3, 1537, [1537, 129], 2, 1e4), (3, 8, 1536, [1376, 0, 700], None, None),
             (2, 2, 127, [31, 33], 1, 1e4), (3, 2, 128, [32, 0, 128], None, None),
             (2, 3, 129, [33, 31], 2, 1e4))
    for dtype in (torch.bfloat16, torch.float32):
        f, name, rel_o, _ = _d128_tag(dtype)
        print(f"kernel 18 at d = 128, {name} (rel bound {rel_o:.0e}; equal to kernel A on "
              "rope_reference-roped inputs)")
        for B, h, n, lens, pe, past in cases:
            q, k, v = (torch.randn((B, h, n, 128), generator=gen, device=dev) for _ in range(3))
            for i, L in enumerate(lens if past else ()):
                k[i, :, L:] = past
                v[i, :, L:] = -past
            q, k, v = (t.to(dtype) for t in (q, k, v))
            kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            cos, sin = (torch.from_numpy(t).to(dev) for t in rope_cos_sin(n, 128))
            label = f"d=128 {name} B={B} heads={h} n={n} kv={lens} pe_attn_head={pe}"
            got = fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin, pe)
            want = fp.flash_prefix_rope_reference(q, k, v, kv, cos, sin, pe)
            want[kv == 0] = 0
            err = compare(f"kernel 18 {label}", got, want, rel_o)[0]
            (qf, kf, vf), lens_h = fp._fold(fp.rope_reference(q, cos, sin, pe),
                                            fp.rope_reference(k, cos, sin, pe), v, kv)
            via_a = fp.flash_prefix_folded(qf, kf, vf, lens_h).reshape(q.shape)
            torch.cuda.synchronize()
            if not torch.equal(got, via_a):
                fail(f"kernel 18 {label}: not kernel A on the roped inputs to the bit")
            if (B, h, n) == (2, 8, 1536):
                print(f"  flash_prefix_rope{f}_d128 at the serving shape:")
                r = _timed(lambda: fp.flash_prefix_rope_attention(q, k, v, kv, cos, sin, pe),
                           lambda: fp.flash_prefix_rope_reference(q, k, v, kv, cos, sin, pe),
                           4.0 * B * h * n * lens[0] * 128, (q, k, v, kv, cos, sin, got),
                           kind="fp32" if f else "bf16")
                n_rope = h if pe is None else pe
                if f:  # the library's attention on the roped inputs
                    r["library_ms"] = cuda_time_ms(efficient_f32_sliced(qf, kf, vf, lens_h))
                    tabs = [t_[:n].float().contiguous() for t_ in (cos, sin)]
                    d128_f32_designs_timed("kernel 18 d=128 fp32", r["ms"],
                                           lambda: d128_ffma(dev, q, k, v, kv, *tabs, heads=h,
                                                             n_rope=n_rope), r)
                else:
                    r["library_ms"] = cuda_time_ms(sdpa_sliced(qf, kf, vf, lens_h))
                    tabs = [t_[:n].to(torch.bfloat16).contiguous() for t_ in (cos, sin)]
                    d128_designs_timed("kernel 18 d=128 bf16", r["ms"],
                                       lambda: d128_mma(dev, q, k, v, kv, *tabs, heads=h,
                                                        n_rope=n_rope), r)
                out[f"flash_prefix_rope{f}_d128"] = {"max_abs_err": err, **r}
    return out


def check_int8_d128(gen, dev) -> dict[str, dict]:
    """Kernel 14 at d = 128 in its four forms ("qkpv" with a bf16 and an
    fp32 output and "qk" on bf16 v on the attention core's int8 D = 128
    kernel, csrc/attn_wgmma.cuh; "qk" on fp32 v split 3xTF32,
    csrc/flash_prefix_int8_d128.cu) and its pass at d = 128
    (csrc/quant_heads.cu), against their plain versions at the serving
    shape ([2, 8, 1536, 128], 1376 keys) and at I8_D128_EDGES: the pass to the bit, 14 within the d = 64 forms' bounds
    (bf16: "qkpv" 2e-3, "qk" 5e-3; fp32: "qkpv" INT8_F32_REL, "qk"
    F32_ATTN_REL, with a bf16 control and, for "qk", a TF32 control that
    must fail them); at the serving shape 4x nearer the plain version at the
    512-key chunk than at the 128-key tile (chunk_check), and its
    quantization error against kernel A at d = 128 printed."""
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        f, name, _, _ = _d128_tag(dtype)
        bounds = {"qkpv": INT8_F32_REL if f else 2e-3, "qk": F32_ATTN_REL if f else 5e-3}
        print(f"kernel 14 at d = 128 and its pass, {name} inputs (rel bounds {bounds})")
        main = None
        for B, H, n, lens, past in ((2, 8, 1536, [1376, 1376], 0.0),) + I8_D128_EDGES:
            q, k, v = (torch.randn((B, H, n, 128), generator=gen, device=dev) for _ in range(3))
            for i, L in enumerate(lens if past else ()):
                for t in (k, v):
                    sign = torch.randint(0, 2, (H, n - L, 128), generator=gen, device=dev)
                    t[i, :, L:] = past * (2.0 * sign - 1)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            label = f"d=128 {name} B={B} heads={H} n={n} kv={lens}{' past +-1e4' if past else ''}"
            for pv_i8 in (True, False):  # the pass, to the bit
                got = fp.quantize_heads(q, k, v, pv_i8)
                q8, k8, vq, c, sv = fp._quantize_qkv(q, k, v, pv_i8)
                want = (q8, k8, fp._v8_kernel_layout(vq) if pv_i8 else vq, c, sv)
                for g, w in zip(got, want):
                    if g.shape != w.shape or not torch.equal(g, w):
                        fail(f"quantization pass {label}: not its plain version to the bit")
            lens_h = kv.repeat_interleave(H)
            live = lens_h > 0
            errs = {}
            for mode, pv_i8 in (("qkpv", True), ("qk", False)):
                got = fp.flash_prefix_attention_i8(q, k, v, kv, pv_i8=pv_i8).reshape(B * H, n, 128)
                want = fp.flash_prefix_i8_reference(q, k, v, lens_h, pv_i8=pv_i8)
                torch.cuda.synchronize()
                if got.dtype != dtype or ((~live).any() and got[~live].abs().max().item() != 0):
                    fail(f"kernel 14 {mode} {label}: wrong dtype or a head with no key not zero")
                errs[mode] = compare(f"kernel 14 {mode} {label}", got[live], want[live],
                                     bounds[mode])[0]
                if main is None and f:  # the controls, at the serving shape
                    control = _rel(want[live].bfloat16(), want[live])
                    print(f"    control: the plain output through bf16 reads rel {control:.3e}"
                          f" (must fail {bounds[mode]:.0e})")
                    if control <= bounds[mode]:
                        fail(f"kernel 14 fp32 {mode}: the bound does not catch a bf16 step")
                    if mode == "qk":
                        tf32_control("kernel 14 fp32 qk d=128", lambda: fp.flash_prefix_i8_reference(
                            q, k, v, lens_h, pv_i8=False)[live], want[live], bounds[mode])
            if main is None:
                main = (q, k, v, kv, lens_h, errs)
        q, k, v, kv, lens_h, errs = main
        B, H, n, L = 2, 8, 1536, 1376
        q8, k8, v8k, c, sv = fp.quantize_heads(q, k, v, True)
        _, _, vq, _, _ = fp.quantize_heads(q, k, v, False)
        v8 = fp._v8_natural_layout(v8k, n)
        fold = [t.reshape(B * H, n, 128).contiguous() for t in (q, k, v)]
        via_a = fp.flash_prefix_folded(*fold, lens_h)
        rows = (torch.arange(n, device=dev)[None, :, None] < lens_h[:, None, None])
        for mode, pv_i8, vv in (("qkpv", True, v8k), ("qk", False, vq)):
            got = fp.flash_prefix_folded_i8(q8, k8, vv, c, sv, lens_h, pv_i8=pv_i8,
                                            out_dtype=dtype)
            if mode == "qkpv" or not f:  # fp32 "qk" keeps p fp32: the chunk moves no rounding
                chunk_check(f"{mode} {name} d=128 main", got, q8, k8, v8 if pv_i8 else vq, c,
                            sv, lens_h, pv_i8)
            qe = ((got.float() - via_a.float()).abs() * rows)
            print(f"    {mode} {name} vs kernel A at d = 128 on the same inputs: max "
                  f"{qe.max().item():.3e}, mean {(qe.sum() / (rows.sum() * 128)).item():.3e} "
                  "(printed)")
            counter = f"flash_prefix_i8{'' if pv_i8 else '_qk'}{f}_d128"
            # S at the int8 rate; P.V at int8 ("qkpv"), bf16 or the 3xTF32 rate (fp32):
            # counted as that kind, the S half scaled by the rates' ratio
            half = 2.0 * B * H * n * L * 128
            kind = "int8" if pv_i8 else ("fp32" if f else "bf16")
            peak = PEAK_OPS["fp32_3xtf32" if kind == "fp32" else kind]
            ops = half + half * peak / PEAK_OPS["int8"]
            print(f"  {counter} at the serving shape:")
            r = _timed(lambda: fp.flash_prefix_folded_i8(q8, k8, vv, c, sv, lens_h, pv_i8=pv_i8,
                                                         out_dtype=dtype),
                       lambda: fp._i8_attention_plain(q8, k8, v8 if pv_i8 else vq, c, sv, lens_h,
                                                      pv_i8, fp.I8_KEY_CHUNK),
                       ops, (q8, k8, vv, c, sv, lens_h, got), kind=kind)
            out[counter] = {"max_abs_err": errs[mode], **r}
        print(f"  flash_prefix_i8_quant{f}_d128 (qkpv) at the serving shape:")
        r = _timed(lambda: fp.quantize_heads(q, k, v, True),
                   lambda: fp._v8_kernel_layout(fp._quantize_qkv(q, k, v, True)[2]), 0.0,
                   (q, k, v, q8, k8, v8k, c, sv), kind="int8")
        out[f"flash_prefix_i8_quant{f}_d128"] = {"max_abs_err": 0.0, **r}  # equal to the bit
        del main, q, k, v, q8, k8, v8k, vq, v8, fold, via_a
        torch.cuda.empty_cache()
    return out


G8_EDGES = ((1, 1), (2, 15), (3, 16), (1, 17), (2, 127), (3, 128), (1, 129), (2, 1536))


def check_conv_g8(gen, dev) -> dict[str, dict]:
    """Kernel C at 8 channels a group (dim 128, 16 groups, 31 taps): the
    pairs of groups packed block-diagonally (ops/grouped_conv.py:
    pack_group_pairs) into the 16-channel instantiation at 8 groups, one
    launch a call on its own counter, against the plain grouped conv at N 1,
    15-17, 127-129, 1536 and B 1-3, with and without bias and Mish (bf16
    rel 5e-3, fp32 F32_REL with cuDNN's TF32 off), timed at [2, 1536, 128]
    beside the library's conv1d(groups=16) + Mish."""
    import torch
    import torch.nn.functional as F

    from korean_f5_tts_tpu_torch.ops import grouped_conv as gc

    out = {}
    C, cg = 128, 8
    for dtype, rel in ((torch.bfloat16, 5e-3), (torch.float32, F32_REL)):
        f = "_f32" if dtype == torch.float32 else ""
        counter = f"launches{f}_g8"
        bnd = (cg * 31) ** -0.5
        w = ((torch.rand((31, cg, C), generator=gen, device=dev) * 2 - 1) * bnd).to(dtype)
        b = ((torch.rand((C,), generator=gen, device=dev) * 2 - 1) * bnd).to(dtype)
        tag = "fp32" if f else "bf16"
        print(f"kernel C at 8 channels a group, {tag} (rel {rel:.0e})")
        err = 0.0
        for B, N in G8_EDGES:
            x = torch.randn((B, N, C), generator=gen, device=dev).to(dtype)
            for bias, mish in ((True, True), (False, True), (True, False), (False, False)):
                be = b if bias else None
                before = (getattr(gc, counter), gc.launches, gc.launches_f32)
                got = gc.grouped_conv1d_mish(x, w, be, 16, mish)
                if (getattr(gc, counter), gc.launches, gc.launches_f32) != (before[0] + 1,
                                                                             *before[1:]):
                    fail(f"kernel C g8 {tag}: not one launch on its own counter")
                err = max(err, compare(f"grouped_conv {tag} cg=8 B={B} N={N} bias={bias} "
                                       f"mish={mish}", got,
                                       gc.grouped_conv1d_mish_reference(x, w, be, 16, mish),
                                       rel)[0])
        x = torch.randn((2, 1536, C), generator=gen, device=dev).to(dtype)
        got = gc.grouped_conv1d_mish(x, w, b, 16)
        flop = 2.0 * 2 * 1536 * C * cg * 31  # the function's products, not the packed zeros
        print(f"  grouped_conv{f}_g8 at [2, 1536, 128]:")
        r = _timed(lambda: gc.grouped_conv1d_mish(x, w, b, 16),
                   lambda: gc.grouped_conv1d_mish_reference(x, w, b, 16), flop, (x, w, b, got),
                   kind="fp32" if f else "bf16")
        wt = w.permute(2, 1, 0).contiguous()
        comp = lambda: F.mish(F.conv1d(x.transpose(1, 2), wt, b, padding=15, groups=16))
        r["library_composition_ms"] = cuda_time_ms(comp)
        print(f"  library composition conv1d(groups=16) + Mish: {r['library_composition_ms']:.4f}"
              " ms (two calls: no one call computes the function)")
        out[f"grouped_conv{f}_g8"] = {"max_abs_err": err, **r}
    return out


def check_head_dim128(gen, dev) -> dict[str, dict]:
    """Phase 2's part for head dim 128 and 8 channels a conv-pos group."""
    out = check_attention_d128(gen, dev)
    check_core_d128(gen, dev)
    out.update(check_rope_d128(gen, dev))
    out.update(check_int8_d128(gen, dev))
    out.update(check_conv_g8(gen, dev))
    return out


def d128_arch(**kw):
    """F5TTS_v1_Base's widths with 8 heads of 128 (dim 1024, ff_mult 2,
    text_dim 512), or those given."""
    from korean_f5_tts_tpu_torch.config import PRESETS, DiTConfig

    return DiTConfig(**{**PRESETS["F5TTS_v1_Base"]["arch"], "heads": 8, "dim_head": 128,
                        "text_num_embeds": 2545, **kw})


def d128_model(dev, arch, dtype, quantize: bool = False):
    from korean_f5_tts_tpu_torch.config import ModelConfig
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import count_params, redraw_zero_init

    model = load_model(ModelConfig(name="F5TTS_v1_Base", backbone="DiT", arch=arch), dtype=dtype,
                       seed=0, device=dev, quantize=quantize)
    redraw_zero_init(model.params, seed=1)
    print(f"  DiT dim {arch.dim} depth {arch.depth} heads {arch.heads}x{arch.dim_head} ff_mult "
          f"{arch.ff_mult}: {count_params(model.params) / 1e6:.1f} M params, "
          f"{'int8 block linears, ' if quantize else ''}{str(dtype).split('.')[-1]}")
    return model


def renamed_d128(want: dict[str, int], attn_path: str, attn_int8: str | None) -> dict[str, int]:
    """expected_launches' counts for the same path on a model with 128-wide
    heads: every attention kernel's d = 128 form, kernel 19 none (the
    unfused path runs kernel A), 14 "qk" on its own counter."""
    out = dict(want)
    for name in ("flash_prefix", "flash_prefix_rope", "flash_prefix_i8",
                 "flash_prefix_i8_quant", "flash_prefix_qkv"):
        n = out.pop(name, 0)
        out[name] = 0
        if not n:
            continue
        to = {"flash_prefix_qkv": "flash_prefix",
              "flash_prefix_i8": "flash_prefix_i8_qk" if attn_int8 == "qk" else name}.get(name,
                                                                                         name)
        out[f"{to}_d128"] = out.get(f"{to}_d128", 0) + n
    return out


def sample_fp32_and_hold(label: str, model, vocoder, want: dict[str, int],
                         attn_path: str = "default", attn_int8: str | None = None) -> None:
    """One fp32 chunk of the bench protocol (the offline entry points' own
    dtype) with kernels, exact launches, the mel against the plain
    versions' within F32_REL over the valid rows (5e-2 under attn_int8, the
    int8 attention's bound of phase 8)."""
    import torch

    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts

    inputs = tuple(t.float() if torch.is_tensor(t) and t.is_floating_point() else t
                   for t in bench_inputs(model.device))
    reset_launch_counts()
    mel_k, _ = synthesize(model, vocoder, inputs, attn_path=attn_path, attn_int8=attn_int8)
    torch.cuda.synchronize()
    counts = launch_counts()
    mel_p, _ = synthesize(model, vocoder, inputs, kernels=False, attn_path=attn_path,
                          attn_int8=attn_int8)
    err = _rel(mel_k[:, :1376], mel_p[:, :1376])
    bound_ = 5e-2 if attn_int8 else F32_REL
    print(f"  {label}: fp32 mel rel err, kernels vs plain {err:.3e} (bound {bound_:.0e}); "
          f"launches {({k: v for k, v in counts.items() if v})}")
    if not torch.isfinite(mel_k).all() or err > bound_:
        fail(f"{label}: the fp32 sampler with kernels disagrees with the plain versions")
    if counts != want:
        fail(f"{label}: launches {counts}, expected {({k: v for k, v in want.items() if v})}")


def phase13_head_dim128(dev, card: str) -> dict[str, int]:
    """Phase 13: F5TTS_v1_Base's widths with 8 heads of 128 served (every
    attn_path, int8 weights, attn_int8 "qk" and "qkpv"; one fp32 chunk per
    attn_path) and trained (bf16 and fp32, full remat, and "dots"); a DiT of
    dim 128 (conv-pos at 8 channels a group); a DiT of dim_head 96 (plain
    attention by shape, as JAX)."""
    import dataclasses

    import torch

    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
    from korean_f5_tts_tpu_torch.ops.attention import sdpa
    from korean_f5_tts_tpu_torch.train.step import loss_and_grads

    t_all = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k_, v_ in counts.items():
            total[k_] += v_

    def lap(tag, t0):
        print(f"  phase 13{tag}: {time.perf_counter() - t0:.1f} s [{card}]")
        return time.perf_counter()

    t0 = time.perf_counter()
    print("phase 13(b): F5TTS_v1_Base widths with 8 heads of 128, depth 22, seeded weights, "
          "the bench protocol")
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    arch = d128_arch()
    model = d128_model(dev, arch, torch.bfloat16)
    for path in ("default", "linear_fused", "rope_in_kernel", "qkv_kernel"):
        want = renamed_d128(expected_launches("bf16", 1, path), path, None)
        sample_and_hold(f"d=128 bf16 attn_path {path}", model, vocoder, want, attn_path=path,
                        card=card, rtf=path == "default")
        add(want)
    for mode in ("qk", "qkpv"):
        want = renamed_d128(expected_launches("bf16", 1, attn_int8=mode), "default", mode)
        sample_and_hold(f"d=128 bf16 attn_int8 {mode}", model, vocoder, want, attn_int8=mode)
        add(want)
    del model
    model = d128_model(dev, arch, torch.bfloat16, quantize=True)
    # batch 1 without a duration mask: 5 and 6 fuse the projections, kernel 9 does not run
    want = {**renamed_d128(expected_launches("int8", 1), "default", None), "qmatmul": 0}
    sample_and_hold("d=128 int8 weights", model, vocoder, want)
    add(want)
    del model
    torch.cuda.empty_cache()
    model = d128_model(dev, arch, torch.float32)
    voc32 = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.float32), vcfg)
    per = DEPTH * STEPS
    for path in ("default", "linear_fused", "rope_in_kernel", "qkv_kernel"):
        attn = "flash_prefix_rope_f32_d128" if path == "rope_in_kernel" else "flash_prefix_f32_d128"
        want = launches_of(**{attn: per, "ff_block_f32": per, "grouped_conv_f32": 2 * STEPS},
                           **({"ln_mod_matmul_f32": per, "proj_gated_residual_f32": per}
                              if path == "linear_fused" else {}))
        sample_fp32_and_hold(f"d=128 fp32 attn_path {path}", model, voc32, want, path)
        add(want)
    for mode in ("qk", "qkpv"):
        want = launches_of(**{f"flash_prefix_i8{'_qk' if mode == 'qk' else ''}_f32_d128": per,
                              "flash_prefix_i8_quant_f32_d128": per, "ff_block_f32": per,
                              "grouped_conv_f32": 2 * STEPS})
        sample_fp32_and_hold(f"d=128 fp32 attn_int8 {mode}", model, voc32, want, attn_int8=mode)
        add(want)
    del model
    torch.cuda.empty_cache()
    t0 = lap("(b)", t0)

    print(f"phase 13(c): training at 8 heads of 128, {BACKBONE_TRAIN_DEPTH} blocks, "
          f"{TRAIN_B} x {TRAIN_N}, full remat, then 'dots'")
    tarch = dataclasses.replace(arch, depth=BACKBONE_TRAIN_DEPTH, checkpoint_activations=True)
    params = redraw_zero_init(init_dit(tarch, seed=0, device=dev), seed=1)
    batch = train_batch(dev)
    d = BACKBONE_TRAIN_DEPTH
    for dtype, bound_ in ((torch.bfloat16, TRAIN_REL), (None, F32_GRAD_REL)):
        f = "" if dtype else "_f32"
        want = launches_of(**{f"flash_prefix_lse{f}_d128": 2 * d,
                              f"flash_prefix_dq_lsein{f}_d128": d,
                              f"flash_prefix_dkv{f}_d128": d})
        reset_launch_counts()
        loss_k, g_k = loss_and_grads(params, batch, 5, tarch, compute_dtype=dtype)
        torch.cuda.synchronize()
        counts = launch_counts()
        loss_p, g_p = loss_and_grads(params, batch, 5, tarch, compute_dtype=dtype, kernels=False)
        gk = torch.cat([g.flatten().float() for g in g_k])
        gp = torch.cat([g.flatten().float() for g in g_p])
        grel, lrel = _rel(gk, gp), abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        print(f"  (c) {'bf16' if dtype else 'fp32'} step: loss {loss_k.item():.5f} (plain "
              f"{loss_p.item():.5f}, rel {lrel:.2e}), gradient rel L2 {grel:.3e} (bound "
              f"{bound_:.0e}); launches {({k_: v_ for k_, v_ in counts.items() if v_})}")
        if not torch.isfinite(gk).all() or grel > bound_ or lrel > bound_:
            fail(f"phase 13 (c) {'bf16' if dtype else 'fp32'}: the step disagrees with plain")
        if counts != want:
            fail(f"phase 13 (c): launches {counts}, expected {want}")
        add(counts)
        if dtype is not None:  # one step under "dots": the attention output is kept
            reset_launch_counts()
            _, g_d = loss_and_grads(params, batch, 5,
                                    dataclasses.replace(tarch, remat_policy="dots"),
                                    compute_dtype=dtype)
            torch.cuda.synchronize()
            cd = launch_counts()
            gdr = _rel(torch.cat([g.flatten().float() for g in g_d]), gk)
            print(f"  (c) 'dots' bf16 step: gradient rel L2 {gdr:.3e} to 'full' (bound 1e-3); "
                  f"kernel 10 {cd['flash_prefix_lse_d128']} (one a block)")
            if gdr > 1e-3 or cd["flash_prefix_lse_d128"] != d:
                fail("phase 13 (c): 'dots' is not 'full' with the attention output kept")
            add(cd)
            del g_d
        del g_k, g_p, gk, gp
        torch.cuda.empty_cache()
        # the backward's own entry point without the lse: A, 12, 13 at d = 128
        add(drive_attention_bwd(dev, batch["lens"], dtype or torch.float32, d=128))
    del params, batch
    t0 = lap("(c)", t0)

    print("phase 13(d): a DiT of dim 128 (1 head of 128, depth 4): conv-pos at 8 channels a "
          "group")
    small = d128_arch(dim=128, depth=4, heads=1, text_dim=128)
    model = d128_model(dev, small, torch.bfloat16)
    want = launches_of(flash_prefix_d128=small.depth * STEPS, ff_block=small.depth * STEPS,
                       grouped_conv_g8=2 * STEPS)
    sample_and_hold("dim 128 DiT", model, vocoder, want)
    add(want)
    model = d128_model(dev, small, torch.float32)
    want = launches_of(flash_prefix_f32_d128=small.depth * STEPS,
                       ff_block_f32=small.depth * STEPS, grouped_conv_f32_g8=2 * STEPS)
    sample_fp32_and_hold("dim 128 DiT", model, voc32, want)
    add(want)
    del model, voc32
    t0 = lap("(d)", t0)

    print("phase 13(e): a DiT with dim_head 96 (8 heads, dim 768, depth 4): the plain attention "
          "by shape, as the JAX package")
    arch96 = d128_arch(dim=768, depth=4, heads=8, dim_head=96)
    model = d128_model(dev, arch96, torch.bfloat16)
    per96 = arch96.depth * STEPS
    for path in ("default", "linear_fused", "rope_in_kernel", "qkv_kernel"):
        want = launches_of(ff_block=per96, **({"ln_mod_matmul": per96,
                                                "proj_gated_residual": per96}
                                               if path == "linear_fused" else {}))
        sample_and_hold(f"dim_head 96 attn_path {path}", model, vocoder, want, attn_path=path)
        add(want)
    for mode in ("qk", "qkpv"):
        sample_and_hold(f"dim_head 96 attn_int8 {mode}", model, vocoder,
                        launches_of(ff_block=per96), attn_int8=mode)
        add(launches_of(ff_block=per96))
    del model
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn((2, 8, 1536, 96), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([1376, 1000], dtype=torch.int32, device=dev)
    reset_launch_counts()
    plain = sdpa(q, k, v, lens, kernels=False)
    same = [torch.equal(sdpa(q, k, v, lens, attn_int8=m), plain) for m in (None, "qk", "qkpv")]
    moved = {k_: v_ for k_, v_ in launch_counts().items() if v_}
    print(f"  sdpa at d = 96 with kernels, attn_int8 None / 'qk' / 'qkpv': equal to the plain "
          f"attention in bf16 {same}; launches {moved}")
    if not all(same) or moved:
        fail("phase 13 (e): d = 96 did not take the plain bf16 attention by shape")
    del q, k, v, vocoder
    torch.cuda.empty_cache()
    lap("(e)", t0)
    print(f"phase 13: {time.perf_counter() - t_all:.1f} s [{card}]")
    return total


# ---------------------------------------------------------------------------
# phase 14: the evaluation harness and the measuring scripts
# ---------------------------------------------------------------------------

ECAPA_REL = 1e-4  # the card's fp32 embedding against the CPU's
ALONE_REL = 5e-2  # a batched item against the same item run alone, bf16
P14_NFE = 32      # the eval harness's default nfe_step
GRID_NFE = 16     # the grid's cells (c), one utterance each per test row
KOREAN_ROWS = ["안녕하세요, 오늘은 평가 문장을 읽어 보겠습니다.", "국물이 정말 맛있어서 같이 먹었어요!"]
KOREAN_REFS = ["첫 번째 참조 음성의 전사입니다.", "두 번째 참조 문장이에요!", "세 번째 참조는 조금 더 길어요?"]
GRID_MODES = ("kor_grapheme", "kor_allophone")


def speech_like(seconds: float, seed: int, f0: float = 150.0):
    """A chirp over a noise floor at 24 kHz (seeded)."""
    import numpy as np

    t = np.arange(int(seconds * SR)) / SR
    noise = np.random.default_rng(seed).standard_normal(t.size)
    return (0.3 * (np.sin(2 * np.pi * (f0 + 300.0 * t) * t) + 0.1 * noise)).astype(np.float32)


def mode_vocab(mode: str, path: Path) -> int:
    """The tokens of every phase-14 text under `mode` (N2gk+ normalised), as
    a vocab file; returns its size."""
    from korean_f5_tts_tpu_torch.train.datasets.prepare import build_vocab, tokenize_rows

    vocab = build_vocab(tokenize_rows([{"text": t} for t in KOREAN_ROWS + KOREAN_REFS], mode,
                                      use_n2gk_plus=True))
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return len(vocab)


def chunks_of(ref_path: str, ref_text: str, text: str) -> int:
    """How many chunks infer_process splits `text` into for this reference,
    once preprocess_ref_audio_text has clipped it and closed its transcript."""
    from korean_f5_tts_tpu_torch.infer.utils_infer import preprocess_ref_audio_text

    (wav, sr), ref_text = preprocess_ref_audio_text(ref_path, ref_text, show_info=lambda *a: None)
    return chunk_count(len(wav) / sr, ref_text, text)


def chunk_count(secs: float, ref_text: str, text: str, speed: float = 1.0) -> int:
    """How many chunks infer_process splits `text` into for a reference of
    `secs` seconds and this transcript (utils_infer.infer_process's
    max_chars)."""
    from korean_f5_tts_tpu_torch.infer.utils_infer import chunk_text

    return len(chunk_text(text, int(len(ref_text.encode("utf-8")) / secs * (22 - secs) * speed)))


def eval_launches(chunks: int, nfe: int, f32: bool = False) -> dict[str, int]:
    """A, B, C per chunk of a DiT of DEPTH blocks at nfe steps (CFG as one batch)."""
    sfx = "_f32" if f32 else ""
    return launches_of(**{f"flash_prefix{sfx}": DEPTH * nfe * chunks,
                          f"ff_block{sfx}": DEPTH * nfe * chunks,
                          f"grouped_conv{sfx}": 2 * nfe * chunks})


def phase14_ecapa(dev, card: str):
    """(a) ECAPA-TDNN at EcapaConfig()'s widths: 3 s of noisy 24 kHz audio
    resampled to 16 kHz, the card's embedding against the CPU's in fp32, with
    cuDNN's process-wide TF32 switch on (PyTorch's default), which the
    encoder turns off for its own call; the TF32 control must fail the
    bound. Returns the card's embed_fn for run_sim."""
    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch.eval.ecapa_tdnn import (
        EcapaConfig,
        ecapa_embed,
        init_ecapa,
        make_embed_fn,
    )

    cfg = EcapaConfig()
    params = init_ecapa(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    wav = speech_like(3.0, seed=3)
    want = make_embed_fn(_to_device(params, torch.device("cpu")), cfg)(wav, SR)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, which the script turned off
    try:
        got = make_embed_fn(params, cfg)(wav, SR)
        restored = torch.backends.cudnn.allow_tf32
        control = make_embed_fn(params, cfg, tf32=True)(wav, SR)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    err_tf32 = float(np.linalg.norm(control - want) / np.linalg.norm(want))
    feats = torch.randn((1, 301, cfg.feat_dim), device=dev)
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: ecapa_embed(params, feats, cfg), runs=10)
    print(f"phase 14 (a) ECAPA-TDNN {cfg}: embedding {got.shape} of 3 s at 24 kHz -> 16 kHz, "
          f"card vs CPU fp32 rel {err:.3e} (bound {ECAPA_REL:.0e}), TF32 convolutions control "
          f"rel {err_tf32:.3e} (must fail the bound); cuDNN's switch back on after the call: "
          f"{restored}; {ms:.3f} ms a 3 s embedding on the card [{card}]")
    if got.shape != (cfg.emb_dim,) or not np.isfinite(got).all() or err > ECAPA_REL:
        fail("ECAPA-TDNN: the card's fp32 embedding disagrees with the CPU's")
    if err_tf32 <= ECAPA_REL:
        fail("ECAPA-TDNN: the TF32 control passes the bound, which would not tell TF32 apart")
    if restored is not True:
        fail("ECAPA-TDNN: cuDNN's TF32 switch was not restored after the call")
    return make_embed_fn(params, cfg)


def phase14_eval(dev, card: str) -> dict[str, int]:
    """Phase 14: the evaluation harness (eval/) and the four measuring scripts
    at F5TTS_v1_Base's full width on seeded weights (AdaLN-zero re-drawn)."""
    import csv
    import dataclasses
    import json
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.eval import eval_infer_batch, evaluate_korean
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.scripts import (
        bench_grpc_live,
        bench_mixed_batch,
        bench_serving_throughput,
        profile_serving_request,
    )
    from korean_f5_tts_tpu_torch.text.vocab import list_str_to_idx, tokenize_text
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax
    from korean_f5_tts_tpu_torch.utils.audio import save_wav

    t_all = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    embed_fn = phase14_ecapa(dev, card)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    refs = []
    for i, secs in enumerate((2.5, 3.0, 3.5)):
        refs.append(str(tmp / f"ref{i}.wav"))
        save_wav(refs[i], speech_like(secs, seed=10 + i, f0=140.0 + 30 * i), SR)
    train = [{"audio_path": refs[i], "text": t, "duration": 3.5 + i}
             for i, t in enumerate(KOREAN_REFS)]
    test = [{"utt": f"t{i:04d}", "text": t} for i, t in enumerate(KOREAN_ROWS)]
    mapping = evaluate_korean.build_reference_mapping(test, train)
    chunks = sum(chunks_of(mapping[r["utt"]]["audio_path"], mapping[r["utt"]]["text"], r["text"])
                 for r in test)

    # (b) evaluate_one_model on F5TTS_v1_Base (bf16, a kor_grapheme vocabulary)
    vocab_size = mode_vocab("kor_grapheme", tmp / "vocab.txt")
    model = load_model(preset_model_config("F5TTS_v1_Base"), vocab_file=str(tmp / "vocab.txt"),
                       tokenizer="kor_grapheme", dtype=torch.bfloat16, seed=0, device=dev)
    redraw_zero_init(model.params, seed=1)
    if (model.arch.dim, model.arch.depth, model.arch.heads) != (1024, DEPTH, 16):
        fail(f"phase 14: expected F5TTS_v1_Base's widths, got {model.arch}")
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    texts = {r["utt"]: r["text"] for r in test}

    def echo(path: str) -> str:  # an ASR that hears the ground truth
        return texts[Path(path).stem]

    out_dir = str(tmp / "cell")
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = evaluate_korean.evaluate_one_model(model, vocoder, test, mapping, out_dir,
                                                 nfe_step=P14_NFE, transcribe_fn=echo,
                                                 embed_fn=embed_fn, seed=5)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = eval_launches(chunks, P14_NFE, f32=True)  # fp32 reference mels, bf16 weights
    rows = list(csv.DictReader(open(Path(out_dir) / "details.csv", encoding="utf-8")))
    print(f"phase 14 (b) evaluate_one_model, F5TTS_v1_Base bf16, kor_grapheme vocab of "
          f"{vocab_size}, {len(test)} Korean rows ({chunks} chunks) at nfe_step {P14_NFE}, "
          f"echo transcriber and ECAPA SIM: {time.perf_counter() - t0:.2f} s [{card}]")
    print("  summary: " + json.dumps(summary, ensure_ascii=False))
    print(f"  launches {counts} (expected {want})")
    if summary.get("cer") != 0.0 or summary.get("wer") != 0.0 or summary.get("n") != len(test):
        fail("evaluate_one_model: CER and WER under the echo transcriber are not 0")
    if not -1.0 <= summary.get("sim", 2.0) <= 1.0 or len(rows) != len(test):
        fail("evaluate_one_model: no speaker similarity, or a row is missing from details.csv")
    if counts != want:
        fail("evaluate_one_model: the kernels did not run as often as the chunks require")
    for name, n in counts.items():
        total[name] += n
    for row in rows:
        wav = wavfile.read(Path(out_dir) / f"{row['utt']}.wav")[1].astype(np.float64)
        if wav.size < 50 * HOP or not np.abs(wav).max() > 0:
            fail(f"evaluate_one_model: {row['utt']}.wav holds no audio")
    reset_launch_counts()
    again = evaluate_korean.evaluate_one_model(model, vocoder, test, mapping, out_dir,
                                               nfe_step=P14_NFE, transcribe_fn=echo, seed=5)
    rows_again = list(csv.DictReader(open(Path(out_dir) / "details.csv", encoding="utf-8")))
    print(f"  a second call (resumed): {len(rows_again)} rows in details.csv (was {len(rows)}), "
          f"launches {sum(launch_counts().values())}, cer {again.get('cer')}")
    if rows_again != rows or sum(launch_counts().values()) != 0:
        fail("evaluate_one_model: a second call synthesized again or added rows")

    # (d) get_inference_prompt and synthesize_bucket: 3 prompts of mixed duration
    # repeats chosen so that b0 and b2 share a 128-frame duration group and b1
    # runs in a group of its own
    meta = [(f"b{i}", KOREAN_REFS[i], refs[i], (KOREAN_ROWS[i % 2] + " ") * reps)
            for i, reps in enumerate((3, 1, 2))]
    prompts = eval_infer_batch.get_inference_prompt(meta, num_buckets=1, min_secs=1.0,
                                                    max_secs=40.0)
    bucket = prompts[0]
    lens = np.array([model.mel_of_wav(it["ref_wav"]).shape[0] for it in bucket])
    ids = list_str_to_idx(tokenize_text([it["ref_text"] + " " + it["gen_text"] for it in bucket],
                                        tokenizer_type=model.tokenizer_type,
                                        vocab=model.vocab_char_map),
                          model.vocab_char_map)
    dur = np.maximum(np.maximum((ids != -1).sum(-1), lens) + 1,
                     [it["total_frames"] for it in bucket])
    groups = len(np.unique(-(-dur // 128)))
    reset_launch_counts()
    t0 = time.perf_counter()
    mels = eval_infer_batch.synthesize_bucket(bucket, model, vocoder, str(tmp / "bucket"),
                                              nfe_step=P14_NFE, seed=11)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = eval_launches(groups, P14_NFE, f32=True)
    errs = {}
    for it in bucket:
        alone = eval_infer_batch.synthesize_bucket([it], model, None, str(tmp / "alone"),
                                                   nfe_step=P14_NFE, seed=11)
        a, b = mels[it["utt"]], alone[it["utt"]]
        errs[it["utt"]] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    print(f"phase 14 (d) synthesize_bucket: {len(bucket)} prompts in one get_inference_prompt "
          f"bucket, durations {dur.tolist()} frames in {groups} duration groups, "
          f"{time.perf_counter() - t0:.2f} s with the items alone [{card}]; each item vs the same "
          f"item alone rel {json.dumps(errs)} (bound {ALONE_REL:.0e}); launches {counts} "
          f"(expected {want})")
    if len(prompts) != 1 or len(bucket) != 3 or groups != 2:
        fail("synthesize_bucket: the 3 prompts should share one bucket and fall into two "
             "duration groups, one of them of two items")
    if max(errs.values()) > ALONE_REL or not all(np.isfinite(m).all() for m in mels.values()):
        fail("synthesize_bucket: a batched item disagrees with the same item run alone")
    if counts != want:
        fail("synthesize_bucket: the kernels did not run as often as the groups require")
    for name, n in counts.items():
        total[name] += n
    del model, vocoder
    torch.cuda.empty_cache()

    # (c) the tokenizer grid through evaluate_korean's main: two modes, one
    # checkpoint each, seeded F5TTS_Base weights at each mode's vocabulary size
    root = tmp / "ckpts"
    sizes = {}
    t0 = time.perf_counter()
    for i, mode in enumerate(GRID_MODES):
        (root / mode).mkdir(parents=True)
        sizes[mode] = mode_vocab(mode, root / mode / "vocab.txt")
        arch = dataclasses.replace(preset_model_config("F5TTS_Base").arch,
                                   text_num_embeds=sizes[mode] + 1)
        params = redraw_zero_init(init_dit(arch, seed=20 + i, device=dev), seed=21 + i)
        np.savez(root / mode / "model_1.npz",
                 **{f"params/{k}": v for k, v in params_to_jax(params).items()})
        del params
    written = time.perf_counter() - t0
    for name, rows_ in (("test.jsonl", [{"audio_path": "", "text": r["text"]} for r in test]),
                        ("train.jsonl", train)):
        with open(tmp / name, "w", encoding="utf-8") as f:
            f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in rows_)
    reset_launch_counts()
    t0 = time.perf_counter()
    grid = evaluate_korean.main([
        "--test_metadata", str(tmp / "test.jsonl"), "--train_metadata", str(tmp / "train.jsonl"),
        "--ckpt_root", str(root), "--modes", *GRID_MODES, "--steps", "1",
        "--results_dir", str(tmp / "grid"), "--nfe_step", str(GRID_NFE)])
    torch.cuda.synchronize()
    counts = launch_counts()
    want = eval_launches(len(GRID_MODES) * chunks, GRID_NFE, f32=True)
    print(f"phase 14 (c) evaluate_korean.main over {list(GRID_MODES)} at step 1 (F5TTS_Base fp32, "
          f"vocab sizes {sizes}), nfe_step {GRID_NFE}: {time.perf_counter() - t0:.2f} s, the two "
          f".npz written in {written:.2f} s [{card}]")
    for r in grid:
        print("  " + json.dumps(r, ensure_ascii=False))
    print(f"  launches {counts} (expected {want})")
    if [(r["mode"], r["step"], r["n"]) for r in grid] != [(m, 1, len(test)) for m in GRID_MODES]:
        fail("run_grid: a cell of the grid is missing")
    if len(set(sizes.values())) != len(GRID_MODES):
        fail("run_grid: the modes should have vocabularies of their own sizes")
    if counts != want:
        fail("run_grid: the fp32 kernels did not run as often as the cells' chunks require")
    for name, n in counts.items():
        total[name] += n
    tmp_dir.cleanup()
    torch.cuda.empty_cache()

    # (e) the four measuring scripts at small counts, each through its main
    def script(label: str, main, argv, must: tuple[str, ...]) -> None:
        print(f"phase 14 (e) {label} [{card}]:", flush=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  {time.perf_counter() - t0:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if not all(counts[k] > 0 for k in must):
            fail(f"{label}: the kernels {must} did not all run")
        torch.cuda.empty_cache()

    bf16 = ("flash_prefix", "ff_block", "grouped_conv")  # serving: all-bf16
    # cfm_sample on fp32 cond beside bf16 or int8 weights: the fp32 forms
    f32 = ("flash_prefix_f32", "ff_block_f32", "grouped_conv_f32")
    int8 = ("flash_prefix_f32", "ff_block_int8", "ln_mod_matmul_int8",
            "proj_gated_residual_int8", "qmatmul", "grouped_conv_f32")
    script("bench_serving_throughput, concurrency 1 and 2, 4 requests of 10 s",
           bench_serving_throughput.main, ["--concurrency", "1", "2", "--n_requests", "4",
                                           "--gen_seconds", "10"], bf16)
    script("bench_mixed_batch, batch 4, 2 iterations, bf16", bench_mixed_batch.main,
           ["--batch", "4", "--iters", "2"], f32)
    script("bench_mixed_batch, batch 4, 2 iterations, int8", bench_mixed_batch.main,
           ["--batch", "4", "--iters", "2", "--int8"], int8)
    script("profile_serving_request, 2 repetitions", profile_serving_request.main,
           ["--reps", "2"], f32)
    script("bench_grpc_live on the in-process client, n 4", bench_grpc_live.main,
           ["--in_process", "--n", "4"], bf16)
    print(f"phase 14: {time.perf_counter() - t_all:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 15: the fine-tuning studio and the inference UI
# ---------------------------------------------------------------------------

STUDIO_MODE = "kor_grapheme"
STUDIO_SENTENCES = ["안녕하세요, 오늘은 제 목소리를 녹음합니다.", "국물이 정말 맛있어서 같이 먹었어요!",
                    "신라의 역사는 아주 길어요.", "값이 얼마인지 물어봐도 될까요?",
                    "내일은 날씨가 맑겠습니다."]
STUDIO_TEXTS = ["짧은 문장을 말해 볼게요.", "두 번째 목소리로 말합니다!"]
STUDIO_FRAMES = 3_000  # the child's frame batch: all five clips of (a) in one batch
STUDIO_UPDATES = 2
STUDIO_NFE = 16
STUDIO_CHILD_TIMEOUT = 420.0


def studio_recording(seed: int = 0):
    """About 29 s of noisy 24 kHz speech-like audio: five segments of 4.8-5.2
    s separated by four pauses of 1.1 s at -80 dB."""
    import numpy as np

    rng = np.random.default_rng(seed + 1000)
    parts = []
    for i, secs in enumerate((5.2, 5.0, 4.8, 5.1, 4.9)):
        if i:
            parts.append((1e-4 * rng.standard_normal(int(1.1 * SR))).astype(np.float32))
        parts.append(speech_like(secs, seed + i, 140.0 + 25 * i))
    return np.concatenate(parts)


def finetune_launches(steps: int, depth: int, remat: bool) -> dict[str, int]:
    """The fp32 forms' launches of `steps` Trainer updates (fp32, no compute
    dtype): per block kernel 10 in the forward (and again in the backward's
    recompute under remat), 11 and 13 once in the backward; nothing else."""
    return launches_of(flash_prefix_lse_f32=(2 if remat else 1) * depth * steps,
                       flash_prefix_dq_lsein_f32=depth * steps,
                       flash_prefix_dkv_f32=depth * steps)


def phase15_studio(dev, card: str) -> dict[str, int]:
    """Phase 15: the fine-tuning studio (train/finetune_gradio.py) from a
    sliced recording to a fine-tuned F5TTS_v1_Base that speaks through the
    inference UI (infer/infer_gradio.py) and the socket client, in a
    temporary working directory."""
    import dataclasses
    import inspect
    import os
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from korean_f5_tts_tpu_torch import socket_client, socket_server
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer import infer_gradio
    from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.text.vocab import load_vocab_file
    from korean_f5_tts_tpu_torch.train import finetune_gradio
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax
    from korean_f5_tts_tpu_torch.utils import gradio_stub
    from korean_f5_tts_tpu_torch.utils.audio import load_wav, save_wav, to_mono

    t_all = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    cwd = os.getcwd()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    os.chdir(tmp)

    def add(counts: dict[str, int]) -> None:
        for name, n in counts.items():
            total[name] += n

    def fp32_launches(chunks: int, nfe: int = STUDIO_NFE) -> dict[str, int]:
        return eval_launches(chunks, nfe, f32=True)

    try:
        # (a) the project: slice, transcribe, prepare, check, suggest
        t0 = time.perf_counter()
        rec = studio_recording()
        save_wav(str(tmp / "recording.wav"), rec, SR)
        proj = finetune_gradio.FinetuneProject("voice", device=dev)
        proj.create()
        clips = proj.slice_audio(str(tmp / "recording.wav"))
        secs = [load_wav(c)[0].shape[-1] / SR for c in clips]
        texts = dict(zip((os.path.basename(c) for c in clips), STUDIO_SENTENCES))
        proj.transcribe_all(lambda path: texts[os.path.basename(path)])
        prepared = proj.prepare_arrow(tokenizer=STUDIO_MODE)
        vocab_path = os.path.join(prepared, "vocab.txt")
        check = finetune_gradio.vocab_check(proj.dir, vocab_path, STUDIO_MODE)
        mem_gb = finetune_gradio.device_memory_gb(dev)
        suggestion = finetune_gradio.calculate_train(prepared, gpu_memory_gb=mem_gb)
        print(f"phase 15 (a) project: {len(rec) / SR:.2f} s recording sliced into {len(clips)} "
              f"clips of {[round(s, 2) for s in secs]} s, transcribed, prepared into {prepared} "
              f"({STUDIO_MODE}, {len(load_vocab_file(vocab_path))} tokens); vocab check "
              f"{check[0]!r}; {time.perf_counter() - t0:.2f} s")
        print(f"  calculate_train for the card's {mem_gb:.2f} GiB: {json.dumps(suggestion)} "
              f"[{card}]")
        if len(clips) != 5 or not all(4.5 < s < 7.0 for s in secs):
            fail("slice_audio: expected five clips of about 5-6 s at the four pauses")
        if check != ("You can train using your language !", ""):
            fail("vocab_check: symbols of the transcripts are missing from the prepared vocab")
        if suggestion.get("total_samples") != 5 or suggestion.get("batch_size_per_gpu", 0) < 30_000:
            fail("calculate_train: no frame budget from the card's memory")

        # (b) the training child: finetune_cli from a seeded .npz, 2 updates
        vocab_size = len(load_vocab_file(vocab_path))
        arch = dataclasses.replace(preset_model_config("F5TTS_v1_Base").arch,
                                   text_num_embeds=vocab_size + 1)
        t0 = time.perf_counter()
        params = redraw_zero_init(init_dit(arch, seed=30, device=dev), seed=31)
        # params and EMA, as the Trainer writes them: from a file without
        # "ema_params/" the Trainer (JAX's too) runs without an EMA
        flat = params_to_jax(params)
        np.savez(tmp / "pretrained.npz", **{f"{tree}/{k}": v for tree in ("params", "ema_params")
                                            for k, v in flat.items()})
        del flat
        del params
        torch.cuda.empty_cache()
        written = time.perf_counter() - t0
        # one checkpoint write, the Trainer's own at --max_updates: a 5 GiB write
        # took ~36 s on the card, and at a save and a last period of 2 the
        # second update writes three (model_2 and model_last twice)
        extra = (f"--pretrain {tmp / 'pretrained.npz'} --max_updates {STUDIO_UPDATES} "
                 f"--batch_size_per_gpu {STUDIO_FRAMES} --save_per_updates {10**9} "
                 f"--last_per_updates {10**9} --num_warmup_updates 1 "
                 f"--learning_rate 1e-4 --logger none")
        t0 = time.perf_counter()
        pid = proj.start_training(exp_name="F5TTS_v1_Base", extra_args=extra,
                                  tokenizer=STUDIO_MODE)
        child = proj._proc
        try:
            out, _ = child.communicate(timeout=STUDIO_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proj.stop_training()
            fail(f"finetune_cli did not finish within {STUDIO_CHILD_TIMEOUT} s")
        wall = time.perf_counter() - t0
        lines = out.decode("utf-8", "replace").strip().splitlines()
        try:
            report = json.loads(lines[-1]) if lines else {}
        except json.JSONDecodeError:
            report = {}
        run_dir = tmp / "ckpts" / f"F5TTS_v1_Base_{STUDIO_MODE}_voice"
        want = finetune_launches(STUDIO_UPDATES, arch.depth, arch.checkpoint_activations)
        print(f"phase 15 (b) the studio's training child (pid {pid}, finetune_cli, F5TTS_v1_Base "
              f"fp32, depth {arch.depth}, {STUDIO_UPDATES} updates of up to {STUDIO_FRAMES} "
              f"frames, from a seeded .npz written in {written:.2f} s): exit "
              f"{child.returncode}, {wall:.2f} s of wall, the child's own "
              f"{report.get('seconds')} s; device {report.get('device')!r}, peak allocated "
              f"{(report.get('max_memory_allocated') or 0) / 2**30:.2f} GiB (calculate_train "
              f"suggests {suggestion['batch_size_per_gpu']} frames) [{card}]")
        print(f"  files: {sorted(p.name for p in run_dir.iterdir()) if run_dir.is_dir() else []}")
        print(f"  the child's launches: { {k: v for k, v in report.get('launches', {}).items() if v} } "
              f"(expected { {k: v for k, v in want.items() if v} })")
        if child.returncode != 0 or not report:
            print("\n".join(lines[-40:]))
            fail("finetune_cli exited with an error or printed no report")
        if torch.device(report["device"]).type != "cuda" or report["steps"] != STUDIO_UPDATES:
            fail("finetune_cli did not take its updates on the card")
        if report["launches"] != want:
            fail("finetune_cli: the kernels did not run as often as the updates require")
        add(report["launches"])
        if proj.is_training():
            fail("is_training after the child exited")
        # a second run, stopped: no process of its session may be left
        pid2 = proj.start_training(exp_name="F5TTS_v1_Base", extra_args=extra,
                                   tokenizer=STUDIO_MODE)
        second = proj._proc
        time.sleep(3.0)
        running = second.poll() is None
        pgid = os.getpgid(second.pid)
        proj.stop_training()
        rc2 = second.wait(timeout=60)
        second.stdout.close()
        left = True
        for _ in range(100):
            try:
                os.killpg(pgid, 0)
            except ProcessLookupError:
                left = False
                break
            time.sleep(0.1)
        print(f"  a second run (pid {pid2}) stopped after 3 s: was running {running}, exit "
              f"{rc2}, processes of its session left: {left}")
        if not running or rc2 != -signal.SIGTERM or left or proj.is_training():
            fail("stop_training did not end the second run's session")

        # (c) prune the child's model_last.npz: its EMA weights only, equal to the source's
        t0 = time.perf_counter()
        last = str(run_dir / "model_last.npz")
        pruned = last.replace(".npz", "_pruned.npz")
        gradio_stub.install(force=True)
        try:
            studio = finetune_gradio.build_app(device=dev)
            prune_btn = studio.find("Button", "Prune")
            prune_btn.events[0].fire("voice_pinyin", last)
            stats = studio.find("Button", "Update Stats").events[0].fire()[0]
        finally:
            gradio_stub.uninstall()
        src, dst = np.load(last), np.load(pruned)
        ema = {k[len("ema_params/"):]: k for k in src.files if k.startswith("ema_params/")}
        kept = {k[len("params/"):] for k in dst.files if k.startswith("params/")}
        others = [k for k in dst.files if not k.startswith("params/") and k != "update"]
        equal = kept == set(ema) and all(np.array_equal(dst[f"params/{k}"], src[ema[k]])
                                         for k in kept)
        moved = equal and any(not np.array_equal(src[f"params/{k}"], src[ema[k]])
                              for k in sorted(kept))
        size = (Path(last).stat().st_size / 2**30, Path(pruned).stat().st_size / 2**30)
        print(f"phase 15 (c) the studio's Prune on model_last.npz ({size[0]:.2f} GiB -> "
              f"{size[1]:.2f} GiB): {len(kept)} EMA tensors kept, equal to the source's: "
              f"{equal}, other keys {others}; {time.perf_counter() - t0:.2f} s")
        print("  the studio's System Info: " + " | ".join(stats.splitlines()[:4]))
        if not equal or others or not kept:
            fail("the pruned checkpoint does not hold exactly the source's EMA weights")
        if not moved:
            fail("the EMA weights equal the trained weights: the file does not tell them apart")
        del src, dst

        # (d) the Test Model tab's core on the pruned file, kernels against plain
        ref_clip, ref_text = clips[0], STUDIO_SENTENCES[0]
        chunks = chunks_of(ref_clip, ref_text, STUDIO_TEXTS[0])
        kw = dict(tokenizer=STUDIO_MODE, vocab_file=vocab_path, nfe_step=STUDIO_NFE, seed=7,
                  device=dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        sr, got = finetune_gradio.test_model_infer(pruned, ref_clip, ref_text, STUDIO_TEXTS[0],
                                                   **kw)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = launch_counts()
        sr_p, want_wav = finetune_gradio.test_model_infer(pruned, ref_clip, ref_text,
                                                          STUDIO_TEXTS[0], kernels=False, **kw)
        err = float(np.linalg.norm(got - want_wav) / np.linalg.norm(want_wav))
        print(f"phase 15 (d) test_model_infer on the pruned file, fp32, {STUDIO_NFE} NFE, "
              f"{chunks} chunk: {got.size} samples at {sr} Hz in {t_k:.2f} s; against "
              f"kernels=False rel {err:.3e} (bound {F32_REL:.0e}); launches "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]")
        if (sr != SR or sr_p != SR or got.shape != want_wav.shape or not np.isfinite(got).all()
                or not np.abs(got).max() > 0 or err > F32_REL):
            fail("test_model_infer with kernels disagrees with kernels=False")
        if counts != fp32_launches(chunks):
            fail("test_model_infer: the fp32 kernels did not run as often as the chunks require")
        add(counts)

        # (e) the inference UI on the pruned file, through the stub's events
        gradio_stub.install(force=True)
        try:
            t0 = time.perf_counter()
            app = infer_gradio.build_app("F5TTS_v1_Base", ckpt_file=pruned,
                                         vocab_file=vocab_path, tokenizer=STUDIO_MODE,
                                         device=dev)
            model = infer_gradio._load_model_cached("F5TTS_v1_Base", pruned, vocab_path,
                                                    STUDIO_MODE, dev)
            print(f"phase 15 (e) infer_gradio.build_app on the pruned file: "
                  f"{len(list(app.walk()))} components, {len(app.all_events)} events, "
                  f"{time.perf_counter() - t0:.2f} s")
            if (model.arch.dim, model.arch.depth, model.arch.heads) != (1024, DEPTH, 16):
                fail(f"phase 15: expected F5TTS_v1_Base's widths, got {model.arch}")
            reset_launch_counts()
            (sr, basic), = app.find("Button", "Synthesize").events[0].fire(
                ref_clip, ref_text, STUDIO_TEXTS[0], False, 0.15, STUDIO_NFE, 1.0)
            torch.cuda.synchronize()
            counts = launch_counts()
            print(f"  Basic TTS: {basic.size} samples, rms {np.sqrt(np.mean(basic ** 2)):.4f}; "
                  f"launches { {k: v for k, v in counts.items() if v} }")
            if sr != SR or not np.isfinite(basic).all() or not np.abs(basic).max() > 0:
                fail("Basic TTS gave no audio")
            if counts != fp32_launches(chunks):
                fail("Basic TTS: the fp32 kernels did not run as often as the chunks require")
            add(counts)

            # two speech types, each with its own reference clip, seed and speed
            n = infer_gradio.MAX_SPEECH_TYPES
            names, audios, refs = [None] * n, [None] * n, [None] * n
            names[:2], audios[:2], refs[:2] = ["Regular", "Calm"], clips[1:3], \
                STUDIO_SENTENCES[1:3]
            script = (f'{{"name": "Regular", "seed": 11, "speed": 1.0}} {STUDIO_TEXTS[0]} '
                      f'{{"name": "Calm", "seed": -1, "speed": 1.2}} {STUDIO_TEXTS[1]}')
            segments = infer_gradio.parse_speechtypes_text(script)
            voices = {nm: (to_mono(load_wav(a)[0]), r) for nm, a, r in
                      zip(names[:2], audios[:2], refs[:2])}
            seg_chunks = sum(chunk_count(len(voices[s["name"]][0]) / SR, voices[s["name"]][1],
                                         s["text"], s["speed"]) for s in segments)
            vocoder = load_vocoder("vocos", device=dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            (sr, multi), lines_ = app.find("Button", "Generate Multi-Style Speech").events[0].fire(
                script, STUDIO_NFE, False, *names, *audios, *refs)
            torch.cuda.synchronize()
            counts = launch_counts()
            t_multi = time.perf_counter() - t0
            used = [json.loads(line[:line.index("}") + 1]) for line in lines_.splitlines()]
            alone = []
            for seg, u in zip(segments, used):
                wav, seg_ref = voices[seg["name"]]
                alone.append(infer_process((wav, SR), seg_ref, seg["text"], model, vocoder,
                                           nfe_step=STUDIO_NFE, seed=u["seed"], speed=u["speed"],
                                           show_info=lambda *a: None)[0])
            split = np.split(multi, np.cumsum([a.size for a in alone])[:-1])
            same = [a.shape == b.shape and float(np.abs(a - b).max()) for a, b in
                    zip(split, alone)]
            print(f"  Multi-Speech-Type, 2 types ({seg_chunks} chunks): {multi.size} samples in "
                  f"{t_multi:.2f} s; cherry-pick lines {lines_.splitlines()}; each segment "
                  f"against infer_process alone with the reported seed, max abs {same}; "
                  f"launches { {k: v for k, v in counts.items() if v} }")
            if [u["name"] for u in used] != ["Regular", "Calm"] or used[0]["seed"] != 11 \
                    or not 0 <= used[1]["seed"] < 2**31 or used[1]["speed"] != 1.2:
                fail("Multi-Speech-Type: the cherry-pick lines do not report each segment")
            if multi.size != sum(a.size for a in alone) or any(s is False or s != 0.0
                                                               for s in same):
                fail("Multi-Speech-Type: a segment differs from infer_process of it alone")
            if counts != fp32_launches(seg_chunks):
                fail("Multi-Speech-Type: the fp32 kernels did not run as often as the chunks "
                     "require")
            add(counts)

            # one voice-chat turn with an injected chat backend (no LLM is loaded)
            hf_backend = infer_gradio.make_hf_chat_backend
            infer_gradio.make_hf_chat_backend = lambda name: (lambda messages: STUDIO_TEXTS[1])
            try:
                session, status = app.find("Button", "Load chat model").events[0].fire(
                    "injected", "Be brief.")
            finally:
                infer_gradio.make_hf_chat_backend = hf_backend
            submit = next(e for e in app.all_events if e.trigger == "submit")
            reset_launch_counts()
            session, conv, (sr, reply) = submit.fire(session, None, "안녕?", ref_clip, ref_text)
            torch.cuda.synchronize()
            counts = launch_counts()
            chat_chunks = chunk_count(to_mono(load_wav(ref_clip)[0]).size / SR, ref_text,
                                      STUDIO_TEXTS[1])
            # the tab leaves the reply's steps at generate_audio_response's default
            chat_nfe = inspect.signature(infer_gradio.VoiceChatSession.generate_audio_response) \
                .parameters["nfe_step"].default
            print(f"  Voice Chat: {status}; conversation {conv}; reply {reply.size} samples "
                  f"({chat_chunks} chunk at {chat_nfe} NFE); launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
            if [m["role"] for m in conv] != ["user", "assistant"] or not np.abs(reply).max() > 0:
                fail("Voice Chat: no reply, or no audio for it")
            if counts != fp32_launches(chat_chunks, chat_nfe):
                fail("Voice Chat: the fp32 kernels did not run as often as the chunks require")
            add(counts)
        finally:
            gradio_stub.uninstall()

        # (f) socket_client against the port's socket server on the same model
        processor = socket_server.TTSStreamingProcessor(model, vocoder, ref_clip, ref_text,
                                                        nfe_step=STUDIO_NFE)
        streamed = []
        generate = processor.generate_stream

        def recorded(text):
            for pcm in generate(text):
                streamed.append(pcm)
                yield pcm

        processor.generate_stream = recorded
        ready, stop, port = threading.Event(), threading.Event(), []
        thread = threading.Thread(target=socket_server.start_server, daemon=True, kwargs=dict(
            processor=processor, host="127.0.0.1", port=0, stop=stop,
            ready=lambda p: (port.append(p), ready.set())))
        thread.start()
        try:
            if not ready.wait(timeout=60):
                fail("the socket server did not come up")
            reset_launch_counts()
            t0 = time.perf_counter()
            pcm = socket_client.request_tts("127.0.0.1", port[0], STUDIO_TEXTS[1])
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            stop.set()
            thread.join(timeout=10)
        sent = np.frombuffer(b"".join(streamed), np.float32)
        sock_chunks = 1  # generate_stream hands infer_batch_process the text whole
        print(f"phase 15 (f) socket_client.request_tts: {pcm.size} float32 samples in "
              f"{time.perf_counter() - t0:.2f} s, {len(streamed)} packets streamed, equal to "
              f"what the server sent: {pcm.shape == sent.shape and np.array_equal(pcm, sent)}; "
              f"launches { {k: v for k, v in counts.items() if v} }")
        if pcm.size < 50 * HOP or not np.array_equal(pcm, sent):
            fail("socket_client: the samples differ from what the server streamed")
        if counts != fp32_launches(sock_chunks):
            fail("socket server: the fp32 kernels did not run as often as the chunks require")
        add(counts)
        del model, vocoder, processor
        infer_gradio._load_model_cached.cache_clear()
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        tmp_dir.cleanup()
    print(f"phase 15: {time.perf_counter() - t_all:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 16: the flagship parity protocol (scripts/flagship_parity.py)
# ---------------------------------------------------------------------------

FLAGSHIP_STEPS = 60  # phase 16's training steps (the script's own default is 1000)
FLAGSHIP_REL = 5e-2  # each fast mode's mel against fp32: a ceiling against a broken path


def flagship_launches(mode: str) -> dict[str, int]:
    """The launches of one utterance of the flagship protocol (batch 1, 22
    blocks x 16 steps, no duration or pad mask) in a mode of
    scripts/flagship_parity.py, all on its fp32 cond (cfm_sample keeps
    cond's dtype): fp32 and bf16 weights the fp32 forms of A and B a block
    and of C twice a step; int8 weights 5, A, 6 and 4 a block on fp32 rows
    and C's fp32 form; int8 attention the fp32 form of kernel 14 and its
    pass in A's place."""
    per = DEPTH * STEPS
    if mode in ("fp32", "bf16"):
        return fp32_path_launches("default", None, False, per, STEPS)
    attn_int8 = mode.split("+", 1)[1] if mode.startswith("int8+") else None
    return fp32_path_launches("default", attn_int8, True, per, STEPS)


def phase16_flagship(dev, card: str) -> dict[str, int]:
    """Phase 16: scripts/flagship_parity.py at F5TTS_Base's full width and
    depth: (a) its modes card and card_int8attn on seeded weights; (b)
    trained_flagship cut to FLAGSHIP_STEPS steps (bf16 compute, remat
    "dots", its checkpoint written to a temporary directory): the last loss
    below the first and the gates' mean |w| above 0. Every utterance's and
    every training step's launches exact, every mel finite (each deviation
    and mean |mel| a finite number), each fast mode within FLAGSHIP_REL of
    fp32 by relative L2 over the valid rows; the protocol's MAE and rel
    printed beside it."""
    import tempfile

    from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.scripts import flagship_parity as fp

    total = dict.fromkeys(KERNELS, 0)

    def add(counts: dict[str, int]) -> None:
        for k, n in counts.items():
            total[k] += n

    def hold(label: str, entry: dict, modes) -> None:
        for mode, got in entry["launches"].items():
            want = {k: n for k, n in flagship_launches(mode).items() if n}
            if got != want:
                fail(f"phase 16 {label} {mode}: launches {got}, expected {want}")
            add(got)
        pairs = [f"{m}_vs_fp32" for m in modes]
        if "int8_vs_bf16" in entry:
            pairs.append("int8_vs_bf16")
        print(f"  {label} (n {entry['n']}, cond {entry['cond_len']}, {entry['nfe']} NFE): "
              f"mean |fp32 mel| {entry['mean_abs_mel_fp32']:.6f} [{card}]")
        for pair in pairs:
            r = entry[pair]
            print(f"    {pair}: mel MAE {r['mel_mae']:.6f}, rel {r['rel']:.6f} (north star "
                  f"{fp.NORTH_STAR:.0e}), rel L2 {r['rel_l2']:.4e}"
                  + (f" (bound {FLAGSHIP_REL:.0e})" if pair.endswith("_vs_fp32") else ""))
            if not all(math.isfinite(x) for x in (*r.values(), entry["mean_abs_mel_fp32"])):
                fail(f"phase 16 {label} {pair}: a mel is not finite")
            if pair.endswith("_vs_fp32") and r["rel_l2"] > FLAGSHIP_REL:
                fail(f"phase 16 {label} {pair}: relative L2 {r['rel_l2']:.3e} to fp32")

    step_want = {k: n for k, n in launches_of(
        flash_prefix_lse=DEPTH, flash_prefix_dq_lsein=DEPTH, flash_prefix_dkv=DEPTH).items() if n}

    def hold_step(i: int, loss, got: dict[str, int]) -> None:
        if i % 10 == 9:
            print(f"    step {i} loss {float(loss):.4f}", flush=True)
        if got != step_want:
            fail(f"phase 16 (b) step {i}: launches {got}, expected {step_want} ('dots')")
        add(got)

    print(f"phase 16: the flagship parity protocol (F5TTS_Base, {fp.ARCH}) [{card}]")
    reset_launch_counts()
    t0 = time.perf_counter()
    card_entry = fp.run_card(dev)
    hold("(a) card, seeded weights", card_entry["flagship_card_fast_modes"], fp.CARD_MODES)
    attn_entry = fp.run_card_int8attn(dev)
    hold("(a) card_int8attn, seeded weights", attn_entry["flagship_card_int8_attn"],
         fp.INT8ATTN_MODES)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trained_entry = fp.run_trained_flagship(dev, steps_trained=FLAGSHIP_STEPS,
                                                ckpt=Path(tmp) / "trained.npz", hold=hold_step)
    trained = trained_entry["flagship_trained_fast_modes_vs_fp32"]
    print(f"  (b) trained_flagship, {FLAGSHIP_STEPS} steps at 8 x 1280 (bf16, 'dots'): loss "
          f"{trained['loss_first']:.4f} -> {trained['loss_last']:.4f}, gates' mean |w| "
          f"{trained['adaln_attn_mod_w_mean_abs']:.4e}, {trained['s_per_step']:.4f} s a step "
          f"after the first; launches a step {step_want} [{card}]")
    if not trained["loss_last"] < trained["loss_first"]:
        fail("phase 16 (b): the loss did not fall")
    if not trained["adaln_attn_mod_w_mean_abs"] > 0.0:
        fail("phase 16 (b): the AdaLN-zero gates did not open")
    hold(f"(b) trained_flagship, {FLAGSHIP_STEPS} steps", trained,
         fp.CARD_MODES + fp.INT8ATTN_MODES)
    if launch_counts() != total:
        fail(f"phase 16: launches {launch_counts()} besides the held ones {total}")
    for entry in (card_entry, attn_entry, trained_entry):
        print(json.dumps(entry))
    print(f"  phase 16: (a) {t1 - t0:.1f} s, (b) {time.perf_counter() - t1:.1f} s")
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                        help="comma-separated phases to run (default: all)")
    parser.add_argument("--profile", type=Path, default=None,
                        help="also profile one bench-protocol utterance per mode, an int8 "
                             "batch of 2 under a duration mask (kernel 9's path), one "
                             "utterance per opt-in attn_path (with phase 7), one fp32 "
                             "utterance chunk on the default path, linear_fused, qkv_kernel "
                             "and attn_int8 'qk' (with phase 8), one with int8 attention (with "
                             "phase 9) and one training step; tables to this file (int8) and "
                             "to its .bf16, .batch2, .<attn_path>, .fp32.<attn_path>, "
                             ".fp32.attn_int8_qk, .attn_int8 and .train siblings")
    parser.add_argument("--ab", type=Path, default=None, metavar="PARENT",
                        help="instead of the phases: time kernels A, B, C, 7, 8, 4, 5, 6, 9, "
                             "10-13, 14 (and its quantization pass), 18 and 19, their fp32 "
                             "forms (C's among them), and the library yardsticks of A, 10 and 11 + 13 (bf16 and "
                             "fp32) of the checkout at PARENT and of this one under one timer, "
                             "in turns parent, change, change, parent (a process each), and "
                             "fail if any kernel is more than 5%% slower than the parent's")
    parser.add_argument("--ab-absent", default="", metavar="NAMES",
                        help="with --ab or --timings-of: kernels of the --ab table (by counter "
                             "name, comma-separated) that the parent tree lacks; its turns skip "
                             "them")
    parser.add_argument("--timings-of", type=Path, default=None, metavar="TREE",
                        help="one turn of --ab: the kernels of the checkout at TREE, as a JSON "
                             "line")
    parser.add_argument("--phase12-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    tree = ROOT if args.timings_of is None else args.timings_of.resolve()
    if not (tree / "korean_f5_tts_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port package is missing in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    # the plain versions are fp32 references: full fp32 products and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    if args.phase12_rank is not None:  # one of phase 12's two ranks, started by phase 12
        phase12_worker(args.phase12_rank)
        return 0

    card = card_line()
    print(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if args.ab is not None:
        ab_timings(args.ab, card, tuple(n for n in args.ab_absent.split(",") if n))
        return 0
    if args.timings_of is not None:
        print(json.dumps(core_timings(dev, tuple(n for n in args.ab_absent.split(",") if n))))
        return 0

    from korean_f5_tts_tpu_torch.ops import KERNELS, cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_seconds if cuda_build.build_seconds is not None else 'cached'} s)")
    name = ""
    for line in cuda_build.build_log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "registers" in line or "spill" in line or "C7513" in line:
            print(f"  ptxas: {name}: {line.strip()}")
    faults = ptxas_faults(cuda_build.build_log)
    if faults:
        fail("ptxas: " + "; ".join(faults))
    # the wall seconds of each phase that ran, since the previous mark (the
    # script's time limit is shared by all of them)
    walls, last = {}, [t0]

    def mark(label: str) -> None:
        now = time.perf_counter()
        walls[label] = round(now - last[0], 1)
        last[0] = now

    mark("1")

    results = {name: {} for name in KERNELS}
    if 2 in phases:
        gen = torch.Generator(device=dev).manual_seed(0)
        print("phase 2: kernels against their plain versions")
        results["flash_prefix"] = check_attention(gen, dev)
        results["ff_block"] = check_ff(gen, dev)
        results["grouped_conv"] = check_conv(gen, dev)
        check_conv_widths(gen, dev)
        check_odd_lengths(gen, dev)
        results["qmatmul"] = check_qmatmul(gen, dev)
        results["ln_mod_matmul_int8"] = check_ln_mod_int8(gen, dev)
        results["proj_gated_residual_int8"] = check_proj_gated_int8(gen, dev)
        results["ff_block_int8"] = check_ff_int8(gen, dev)
        check_int8_fp32_rows(gen, dev)
        results.update(check_train_attention(gen, dev))
        results.update(check_train_attention_f32(gen, dev))
        results["ln_mod_matmul"] = check_ln_mod(gen, dev)
        results["proj_gated_residual"] = check_proj_gated(gen, dev)
        results.update(check_rope_attention(gen, dev))
        results.update(check_attention_int8(gen, dev))
        results.update(check_fp32_forms(gen, dev))
        results.update(check_fp32_attn_paths(gen, dev))
        check_tp_shards(gen, dev)
        results.update(check_head_dim128(gen, dev))
        from korean_f5_tts_tpu_torch.scripts import probe_hopper

        probe_hopper.run(dev)
        # across calls only a hint (another card or host may differ): --ab holds
        # B, 7, 8 to their parent's times under one timer
        print("B, 7, 8 (bf16 core) against their times in PERF.md section 6: " + ", ".join(
            f"{AB_KERNELS[n]} {results[n]['ms']:.4f} / {BF16_CORE_MS[n]} = "
            f"{results[n]['ms'] / BF16_CORE_MS[n]:.3f}" for n in BF16_CORE_MS))
        mark("2")

    counts = dict.fromkeys(KERNELS, 0)
    if phases & {3, 4, 5, 7} or args.profile is not None:
        bf16_plain = None
        for mode in ("bf16", "int8") if phases & {3, 4, 5} or args.profile else ("bf16",):
            model, vocoder = build_model(dev, quantize=mode == "int8")
            if 3 in phases:
                for name, n in phase3_serve(model, vocoder, mode).items():
                    counts[name] += n
            if 4 in phases:
                bf16_plain = phase4_parity(model, vocoder, dev, mode, bf16_plain)
            rtf = phase5_rtf(model, vocoder, dev, card, mode) if 5 in phases else None
            if args.profile is not None:
                path = args.profile if mode == "int8" else args.profile.with_suffix(".bf16.txt")
                inputs = bench_inputs(dev)
                profile_once(lambda: synthesize(model, vocoder, inputs), path, mode)
                if mode == "int8":  # the batch on which kernel 9 runs
                    inputs2, mask2 = batch2_inputs(dev)
                    profile_once(lambda: synthesize(model, vocoder, inputs2, mask=mask2),
                                 path.with_suffix(".batch2.txt"),
                                 "int8, a batch of 2 under a duration mask")
            if mode == "bf16" and 7 in phases:
                for name, n in phase7_attn_paths(model, vocoder, dev, card, rtf,
                                                 args.profile).items():
                    counts[name] += n
            del model, vocoder
            torch.cuda.empty_cache()
        mark("3-5,7")
    if 8 in phases:
        for name, n in phase8_offline(dev, card).items():
            counts[name] += n
        if args.profile is not None:
            profile_fp32_chunks(args.profile)
        mark("8")
    if 9 in phases:
        for name, n in phase9_int8_attention(dev, card, args.profile).items():
            counts[name] += n
        mark("9")
    if 12 in phases:  # before 6: the profiler slows every launch after it
        for name, n in phase12_parallel(dev, card).items():
            counts[name] += n
        torch.cuda.empty_cache()
        mark("12")
    if 11 in phases:  # before 6: the profiler slows every launch after it
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            for name, n in phase11_backbones(dev, card, Path(tmp)).items():
                counts[name] += n
        torch.cuda.empty_cache()
        mark("11")
    if 13 in phases:  # before 6: the profiler slows every launch after it
        for name, n in phase13_head_dim128(dev, card).items():
            counts[name] += n
        torch.cuda.empty_cache()
        mark("13")
    if 14 in phases:  # before 6: the profiler slows every launch after it
        for name, n in phase14_eval(dev, card).items():
            counts[name] += n
        torch.cuda.empty_cache()
        mark("14")
    if 15 in phases:  # before 6: the profiler slows every launch after it
        for name, n in phase15_studio(dev, card).items():
            counts[name] += n
        torch.cuda.empty_cache()
        mark("15")
    if 16 in phases:  # before 6: the profiler slows every launch after it
        for name, n in phase16_flagship(dev, card).items():
            counts[name] += n
        torch.cuda.empty_cache()
        mark("16")
    lora_profile = None
    if 10 in phases:  # before 6: the profiler slows every launch after it
        phase10_counts, lora_profile = phase10_finetune(dev, card)
        for name, n in phase10_counts.items():
            counts[name] += n
        mark("10")
    if 6 in phases:  # last: it profiles a step, and the profiler slows every launch after it
        train_profile = None if args.profile is None else args.profile.with_suffix(".train.txt")
        for name, n in phase6_train(dev, card, train_profile).items():
            counts[name] += n
        mark("6")
    if lora_profile is not None:  # phase 10's profile, after every timing
        lora_profile()
    print(f"wall seconds by phase (phase 1 from its build on): {walls}, in all "
          f"{sum(walls.values()):.1f}")
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": results[name].get("max_abs_err"),
                "ms": results[name].get("ms"), "plain_ms": results[name].get("plain_ms"),
                "bound_ms": results[name].get("bound_ms"),
                "bound_by": results[name].get("bound_by"),
                "library_ms": results[name].get("library_ms"),
                **{k: results[name][k] for k in ("library_composition_ms",) if k in results[name]}}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
